// Frame-axis (temporal) multi-head attention backward, bf16, for Hopper (sm_90a).
//
// Replaces: humanvid_tpu/ops/temporal_attention.py, the Pallas kernel
// `_bwd_kernel`, launched by `_call_bwd` through `_temporal_bwd`.
//
// Computes, for each (b, position l, head h), the gradient of
//   out = softmax_over_frames(q k^T * d^-1/2) v
// (the forward of csrc/temporal_attention.cu) given g = dL/dout, on
// q/k/v/g/dq/dk/dv of shape (b, f, l, c) with heads packed in c, f <= 32
// (more: the long kernel at the end of this file):
//   p  = softmax(q k^T * scale)            (recomputed, fp32)
//   dv = p^T g
//   dp = g v^T,  delta = rowsum(dp * p),  ds = p * (dp - delta)
//   dq = ds k * scale,  dk = ds^T q * scale
// with p and ds rounded to bf16 before their products, as the JAX kernel
// does. One pass, no residual beyond q, k and v.
//
// What bounds it on the H100: device-memory bytes. Each position's f x f
// attention is tiny: at the motion modules' level 0 a call is 13.2 GFLOP
// (13 us at the bf16 peak) against the 771 MB of q, k, v, g, dq, dk and dv
// (230 us). The first design (a warp per (position, head), synchronous
// 16-byte loads of one head's 80-byte row pieces, nothing overlapped, four
// 32-row tiles per warp in shared memory, 4-byte stores from the mma
// fragments) reached 22-40% of that bound.
//
// What this design does about it (the forward's item and ring):
// - A work item is one position x all f frames x a chunk of whole heads
//   (the wrapper's `temporal_plan`: the UNet's 320-byte row pieces at every
//   level), one TMA load per tensor of q, k, v and g from a 4-D map
//   (c, l, f, b), `cwp` columns wide: frames past f and columns past c
//   read zeros, so a box never crosses into the next sample, and a frame
//   row is an odd number of 16-byte units (the ldmatrix rows of one head,
//   a frame apart, fall in distinct banks).
// - One producer thread keeps a ring of kStages items in flight (mbarriers
//   with transaction counts) over a persistent grid.
// - kConsumers consumer warps each take one (position, head) of an item at
//   a time with `mma.sync.m16n8k16` (bf16 in, fp32 accumulate): S = Q K^T
//   and dP = G V^T, the softmax in the log2 domain, delta and dS in fp32
//   registers, then dV = P^T G, dQ = dS K * scale and dK = dS^T Q * scale.
//   The transposed A operands P^T and dS^T come from the register
//   fragments by `movmatrix` (no shared memory). `wgmma` is not used: its
//   64-row M would pad f = 24 by 2.7x, and the products are not what
//   bounds the kernel. At f <= 16 the tiles are 16 frames (MT = 1), not 32.
// - The mma tiles run to 16 * MT frames, and a tile in shared memory holds
//   only the f frames TMA writes: its rows past f are the next tile's (or
//   the room after the last), which another warp may be overwriting. The
//   columns past d of a head's last 16-deep step are the next head's.
//   Every such value is removed by a select, never by a multiply (0 x Inf
//   is NaN): rows past f of every B operand of the output products, P and
//   dS at query or key frames past f, dP at key frames past f, and both
//   operands' columns past d in the last step of S and dP. So an Inf in one
//   head, position or sample reaches no other's gradients.
// - The three gradients leave without tiles of their own: each is written
//   over an input its warp no longer needs, in the head's own columns
//   (dP read V last, so dV goes into V; dV read G last, so dQ goes into G;
//   dQ read K last, so dK goes into K). Once every warp has freed the item
//   the producer stores each gradient by one 1-D bulk copy per frame row
//   of the chunk (3 x f an item), and reloads the stage only after those
//   copies have read it. Three stages of q, k, v and g tiles of 24 x 168
//   bf16 are 97 KB at f = 24: two blocks an SM at every level.
// - On the host a launch encodes the four maps and launches; the function's
//   shared memory limit and the persistent grid are asked of the runtime
//   once per item size (`HostCache`).
// No atomics: a repeat launch gives the same bits, and each sample's
// gradients do not depend on the other samples.

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
constexpr bool kInPlace = true;   // gradients over dead inputs (else tiles of their own)
constexpr bool kMovmatrix = true;  // P^T, dS^T by movmatrix (else through shared memory)
constexpr int kOTiles = kInPlace ? 0 : kStages;  // sets of dQ, dK, dV tiles
constexpr int kThreads = 32 * (kConsumers + 1);
constexpr int LP = kMaxFrames + 8;  // row stride of a warp's transpose tile (80 bytes)
constexpr float kLog2e = 1.4426950408889634f;

// Elements of one stage's Q, K, V or G tile ([F][cwp]) and of a gradient
// tile ([F][cw]), each rounded to 128 bytes (TMA's alignment).
__host__ __device__ inline int tile_elems(int F, int cols) { return (F * cols + 63) / 64 * 64; }

// Elements of the room past the last stage for the mma tiles' rows past F
// (read, never used), rounded the same way.
__host__ __device__ inline int room_elems(int F, int cwp) {
  return ((kMaxFrames - F) * cwp + 63) / 64 * 64;
}

// The stages' Q, K, V and G tiles, the room past them, the gradient tiles,
// the warps' transpose tiles, then the mbarriers.
__host__ __device__ inline size_t smem_bytes(int F, int cw, int cwp) {
  return 128 + ((size_t)kStages * 4 * tile_elems(F, cwp) + (size_t)room_elems(F, cwp) +
                (size_t)kOTiles * 3 * tile_elems(F, cw) +
                (kMovmatrix ? 0 : (size_t)kConsumers * kMaxFrames * LP)) * 2 +
         2 * kStages * 8;
}

// Zero the halves of a bf16 pair that hold frames >= F.
__device__ __forceinline__ uint32_t mask_frames(uint32_t v, int frame, int F) {
  return v & ((frame < F ? 0x0000ffffu : 0u) | (frame + 1 < F ? 0xffff0000u : 0u));
}

__device__ __forceinline__ uint32_t movmatrix_trans(uint32_t x) {
  uint32_t y;
  asm volatile("movmatrix.sync.aligned.m8n8.trans.b16 %0, %1;\n" : "=r"(y) : "r"(x));
  return y;
}

// acc = A B^T over the head's d columns, for A and B of 16 * MT frames
// (rows LDF apart): acc[mt][j] is rows 16mt.., columns 8j.. . In the last
// 16-deep step both operands' columns past d are zeroed.
template <int DP, int MT>
__device__ __forceinline__ void rows_by_rows(float (&acc)[MT][2 * MT][4], const bf16* sa,
                                             const bf16* sb, int LDF, int d, int lane) {
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int j = 0; j < 2 * MT; ++j) acc[mt][j][0] = acc[mt][j][1] = acc[mt][j][2] = acc[mt][j][3] = 0.f;
#pragma unroll
  for (int kk = 0; kk < DP / 16; ++kk) {
    if (16 * kk >= d) break;
    const bool tail = 16 * kk + 8 >= d;
    uint32_t a[MT][4];
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) {
      ldmatrix_x4(a[mt], sa + (mt * 16 + lane % 16) * LDF + kk * 16 + (lane / 16) * 8);
      if (tail) a[mt][2] = a[mt][3] = 0u;
    }
#pragma unroll
    for (int jp = 0; jp < MT; ++jp) {
      uint32_t b[4];
      ldmatrix_x4(b, sb + (jp * 16 + (lane % 8) + (lane / 16) * 8) * LDF + kk * 16 +
                         ((lane / 8) % 2) * 8);
      if (tail) b[1] = b[3] = 0u;
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        mma_bf16(acc[mt][2 * jp], a[mt], b[0], b[1]);
        mma_bf16(acc[mt][2 * jp + 1], a[mt], b[2], b[3]);
      }
    }
  }
}

// y = the A fragments of X^T, for x the A fragments of X (16 * MT square,
// x[mt][t] = rows 16mt.., columns 16t..): by movmatrix, or through the
// warp's transpose tile `scratch` and ldmatrix.trans.
template <int MT>
__device__ __forceinline__ void transpose_a(const uint32_t (&x)[MT][MT][4],
                                            uint32_t (&y)[MT][MT][4], bf16* scratch, int lane) {
  if constexpr (kMovmatrix) {
    // the 8x8 blocks of x[t][mk] are (rows, columns) (0,0), (8,0), (0,8), (8,8)
#pragma unroll
    for (int mk = 0; mk < MT; ++mk)
#pragma unroll
      for (int t = 0; t < MT; ++t) {
        y[mk][t][0] = movmatrix_trans(x[t][mk][0]);
        y[mk][t][1] = movmatrix_trans(x[t][mk][2]);
        y[mk][t][2] = movmatrix_trans(x[t][mk][1]);
        y[mk][t][3] = movmatrix_trans(x[t][mk][3]);
      }
  } else {
    const int g = lane / 4, c = 2 * (lane % 4);
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int t = 0; t < MT; ++t)
#pragma unroll
        for (int i = 0; i < 4; ++i)
          *reinterpret_cast<uint32_t*>(scratch + (16 * mt + 8 * (i & 1) + g) * LP + 16 * t +
                                       8 * (i >> 1) + c) = x[mt][t][i];
    __syncwarp();
#pragma unroll
    for (int mk = 0; mk < MT; ++mk)
#pragma unroll
      for (int t = 0; t < MT; ++t)
        ldmatrix_x4_trans(y[mk][t], scratch + (16 * t + 8 * (lane / 16) + lane % 8) * LP +
                                        16 * mk + 8 * ((lane / 8) % 2));
    __syncwarp();
  }
}

// out = A B (16 * MT rows x d columns), A as register fragments a[mt][t]
// (rows 16mt.., contracted frames 16t..), B from shared memory (the
// contracted frames' rows, LDF apart; rows >= F zeroed in the fragments),
// stored times `mul` as bf16 to dst's rows < F and columns < d (rows LDO
// apart), in chunks of 64 columns.
template <int DP, int MT>
__device__ __forceinline__ void product_store(const uint32_t (&a)[MT][MT][4], const bf16* sb,
                                              int LDF, bf16* dst, int LDO, int F, int d,
                                              float mul, int lane) {
  constexpr int kMaxTiles = 8;
#pragma unroll
  for (int n0 = 0; n0 < DP; n0 += 64) {
    if (n0 >= d) break;
    float o[MT][kMaxTiles][4];
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int n = 0; n < kMaxTiles; ++n) o[mt][n][0] = o[mt][n][1] = o[mt][n][2] = o[mt][n][3] = 0.f;
#pragma unroll
    for (int t = 0; t < MT; ++t) {
#pragma unroll
      for (int np = 0; np < kMaxTiles / 2; ++np) {
        if (n0 + 16 * np >= DP || n0 + 16 * np >= d) break;
        uint32_t b[4];
        ldmatrix_x4_trans(b, sb + (t * 16 + (lane % 8) + ((lane / 8) % 2) * 8) * LDF + n0 +
                                 np * 16 + (lane / 16) * 8);
        // registers 0 and 2 hold frames t*16 + 2*(lane%4) (+1), 1 and 3 eight later
        const int fr = t * 16 + 2 * (lane % 4);
        b[0] = mask_frames(b[0], fr, F);
        b[2] = mask_frames(b[2], fr, F);
        b[1] = mask_frames(b[1], fr + 8, F);
        b[3] = mask_frames(b[3], fr + 8, F);
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) {
          mma_bf16(o[mt][2 * np], a[mt][t], b[0], b[1]);
          mma_bf16(o[mt][2 * np + 1], a[mt][t], b[2], b[3]);
        }
      }
    }
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int n = 0; n < kMaxTiles; ++n) {
        if (n0 + 8 * n >= DP || n0 + 8 * n >= d) break;
        const int col = n0 + 8 * n + 2 * (lane % 4);
        const int row = 16 * mt + lane / 4;
        if (row < F)
          *reinterpret_cast<__nv_bfloat162*>(dst + row * LDO + col) =
              __floats2bfloat162_rn(o[mt][n][0] * mul, o[mt][n][1] * mul);
        if (row + 8 < F)
          *reinterpret_cast<__nv_bfloat162*>(dst + (row + 8) * LDO + col) =
              __floats2bfloat162_rn(o[mt][n][2] * mul, o[mt][n][3] * mul);
      }
  }
}

// P and dS (as the A fragments of the output products, [query tile][key
// step]) from S = Q K^T and dP = G V^T of one (position, head): the softmax
// in the log2 domain (keys >= F masked), delta = rowsum(dP * P), dS = P (dP
// - delta). Element e of tile (mt, j) is key frame 8j + 2*(lane%4) + (e&1)
// of query frame 16mt + lane/4 + 8*(e>>1).
template <int MT>
__device__ __forceinline__ void probs_and_ds(float (&p)[MT][2 * MT][4],
                                             float (&dp)[MT][2 * MT][4],
                                             uint32_t (&pa)[MT][MT][4], uint32_t (&da)[MT][MT][4],
                                             int F, float scale_log2, int lane) {
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int j = 0; j < 2 * MT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int key = 8 * j + 2 * (lane % 4) + (e & 1);
        p[mt][j][e] = key < F ? p[mt][j][e] * scale_log2 : -INFINITY;
        dp[mt][j][e] = key < F ? dp[mt][j][e] : 0.f;
        mx[e >> 1] = fmaxf(mx[e >> 1], p[mt][j][e]);
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
        p[mt][j][e] = exp2f(p[mt][j][e] - mx[e >> 1]);
        sum[e >> 1] += p[mt][j][e];
      }
    float delta[2] = {0.f, 0.f};
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      sum[r] += __shfl_xor_sync(0xffffffffu, sum[r], 1);
      sum[r] += __shfl_xor_sync(0xffffffffu, sum[r], 2);
      sum[r] = 1.f / sum[r];
    }
#pragma unroll
    for (int j = 0; j < 2 * MT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        p[mt][j][e] *= sum[e >> 1];
        delta[e >> 1] += p[mt][j][e] * dp[mt][j][e];
      }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      delta[r] += __shfl_xor_sync(0xffffffffu, delta[r], 1);
      delta[r] += __shfl_xor_sync(0xffffffffu, delta[r], 2);
    }
    // dS = P (dP - delta); both zero at query or key frames >= F
#pragma unroll
    for (int j = 0; j < 2 * MT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int key = 8 * j + 2 * (lane % 4) + (e & 1);
        const int query = 16 * mt + lane / 4 + 8 * (e >> 1);
        const bool valid = key < F && query < F;
        dp[mt][j][e] = valid ? p[mt][j][e] * (dp[mt][j][e] - delta[e >> 1]) : 0.f;
        p[mt][j][e] = valid ? p[mt][j][e] : 0.f;
      }
#pragma unroll
    for (int t = 0; t < MT; ++t) {
      pa[mt][t][0] = pack_bf16(p[mt][2 * t][0], p[mt][2 * t][1]);
      pa[mt][t][1] = pack_bf16(p[mt][2 * t][2], p[mt][2 * t][3]);
      pa[mt][t][2] = pack_bf16(p[mt][2 * t + 1][0], p[mt][2 * t + 1][1]);
      pa[mt][t][3] = pack_bf16(p[mt][2 * t + 1][2], p[mt][2 * t + 1][3]);
      da[mt][t][0] = pack_bf16(dp[mt][2 * t][0], dp[mt][2 * t][1]);
      da[mt][t][1] = pack_bf16(dp[mt][2 * t][2], dp[mt][2 * t][3]);
      da[mt][t][2] = pack_bf16(dp[mt][2 * t + 1][0], dp[mt][2 * t + 1][1]);
      da[mt][t][3] = pack_bf16(dp[mt][2 * t + 1][2], dp[mt][2 * t + 1][3]);
    }
  }
}

// dV = P^T G, dQ = dS K * scale and dK = dS^T Q * scale over d columns,
// stored to ov, oq and ok (frames LDO apart; in place: ov over V, oq over
// G once dV has read it, ok over K once dQ has).
template <int DP, int MT>
__device__ __forceinline__ void grads_store(const uint32_t (&pa)[MT][MT][4],
                                            const uint32_t (&da)[MT][MT][4], const bf16* sq,
                                            const bf16* sk, const bf16* sg, int LDF, bf16* oq,
                                            bf16* ok, bf16* ov, int LDO, bf16* scratch, int F,
                                            int d, float scale, int lane) {
  uint32_t ta[MT][MT][4];
  transpose_a<MT>(pa, ta, scratch, lane);
  // each product's reads of shared memory before the next one's writes
  __syncwarp();
  product_store<DP, MT>(ta, sg, LDF, ov, LDO, F, d, 1.f, lane);    // dV = P^T G
  __syncwarp();
  product_store<DP, MT>(da, sk, LDF, oq, LDO, F, d, scale, lane);  // dQ = dS K
  transpose_a<MT>(da, ta, scratch, lane);
  __syncwarp();
  product_store<DP, MT>(ta, sq, LDF, ok, LDO, F, d, scale, lane);  // dK = dS^T Q
}

// One (position, head) of an item: sq/sk/sv/sg point at the head's first
// column of frame 0 of each input tile (frames LDF apart), oq/ok/ov at the
// same place of the gradients' (frames LDO apart; in place, sg/sk/sv).
template <int DP, int MT>
__device__ __forceinline__ void head_grad(const bf16* sq, const bf16* sk, const bf16* sv,
                                          const bf16* sg, int LDF, bf16* oq, bf16* ok, bf16* ov,
                                          int LDO, bf16* scratch, int F, int d, float scale_log2,
                                          float scale, int lane) {
  float p[MT][2 * MT][4], dp[MT][2 * MT][4];
  rows_by_rows<DP, MT>(p, sq, sk, LDF, d, lane);   // S = Q K^T
  rows_by_rows<DP, MT>(dp, sg, sv, LDF, d, lane);  // dP = G V^T
  uint32_t pa[MT][MT][4], da[MT][MT][4];
  probs_and_ds<MT>(p, dp, pa, da, F, scale_log2, lane);
  grads_store<DP, MT>(pa, da, sq, sk, sg, LDF, oq, ok, ov, LDO, scratch, F, d, scale, lane);
}

// The item's coordinates: (chunk, position, sample).
struct Item {
  int chunk, pos, b;
};

__device__ __forceinline__ Item item_of(int it, int chunks, int L) {
  Item r;
  r.chunk = it % chunks;
  r.pos = (it / chunks) % L;
  r.b = it / (chunks * L);
  return r;
}

// Store item w's dQ, dK and dV, in the producer's current bulk group: in
// place, one bulk copy per frame row of the stage's G, K and V tiles (t,
// frames cwp apart); else one TMA store per gradient tile (o, [F][cw]).
__device__ __forceinline__ void store_item(const Item& w, const bf16* t, const bf16* o,
                                           bf16* dq, bf16* dk, bf16* dv,
                                           const CUtensorMap* dq_map, const CUtensorMap* dk_map,
                                           const CUtensorMap* dv_map, int F, int L, int C,
                                           int CW, int CWP, int TILE, int OTILE) {
  if constexpr (kInPlace) {
    const bf16* src[3] = {t + 3 * TILE, t + TILE, t + 2 * TILE};  // dQ in G, dK in K, dV in V
    bf16* dst[3] = {dq, dk, dv};
#pragma unroll
    for (int i = 0; i < 3; ++i)
      for (int r = 0; r < F; ++r)
        bulk_store(dst[i] + (((size_t)w.b * F + r) * L + w.pos) * C + (size_t)w.chunk * CW,
                   src[i] + (size_t)r * CWP, (uint32_t)CW * 2);
  } else {
    tma_store_4d(dq_map, o, w.chunk * CW, w.pos, 0, w.b);
    tma_store_4d(dk_map, o + OTILE, w.chunk * CW, w.pos, 0, w.b);
    tma_store_4d(dv_map, o + 2 * OTILE, w.chunk * CW, w.pos, 0, w.b);
  }
}

// grid: persistent, at most one block per item; block kThreads.
template <int DP, int MT>
__global__ void __launch_bounds__(kThreads)
temporal_bwd_kernel(const __grid_constant__ CUtensorMap q_map,
                    const __grid_constant__ CUtensorMap k_map,
                    const __grid_constant__ CUtensorMap v_map,
                    const __grid_constant__ CUtensorMap g_map,
                    const __grid_constant__ CUtensorMap dq_map,
                    const __grid_constant__ CUtensorMap dk_map,
                    const __grid_constant__ CUtensorMap dv_map, bf16* __restrict__ dq,
                    bf16* __restrict__ dk, bf16* __restrict__ dv, int B, int F, int L, int C,
                    int d, int CW, int CWP, float scale_log2, float scale) {
  extern __shared__ unsigned char smem_raw[];
  bf16* tiles = reinterpret_cast<bf16*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 127) & ~static_cast<uintptr_t>(127));
  const int TILE = tile_elems(F, CWP), OTILE = tile_elems(F, CW);
  const int STAGE = 4 * TILE;  // Q, K, V, G
  bf16* otiles = tiles + (size_t)kStages * STAGE + room_elems(F, CWP);
  bf16* scratch = otiles + (size_t)kOTiles * 3 * OTILE;
  uint64_t* full = reinterpret_cast<uint64_t*>(
      scratch + (kMovmatrix ? 0 : (size_t)kConsumers * kMaxFrames * LP));
  uint64_t* empty = full + kStages;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int chunks = C / CW;
  const int tasks = CW / d;  // heads of an item
  const int items = B * L * chunks;

  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      // the loads' bytes (and, with gradient tiles, the tile free again)
      mbar_init(&full[s], kInPlace ? 1 : 2);
      mbar_init(&empty[s], kConsumers);
    }
    fence_barrier_init();
  }
  __syncthreads();

  if (warp == kConsumers) {
    // producer (one thread): a stage's previous item is stored, then the
    // next loaded into it
    if (lane != 0) return;
    const uint32_t bytes = 4u * F * CWP * 2;
    int n = 0;
    for (int it = blockIdx.x; it < items; it += gridDim.x, ++n) {
      const int s = n % kStages;
      bf16* t = tiles + (size_t)s * STAGE;
      if (n >= kStages) {
        mbar_wait(&empty[s], ((n / kStages) - 1) & 1);
        store_item(item_of(it - kStages * gridDim.x, chunks, L), t, otiles + (size_t)s * 3 * OTILE,
                   dq, dk, dv, &dq_map, &dk_map, &dv_map, F, L, C, CW, CWP, TILE, OTILE);
        bulk_commit();
        // in place, the stores read the stage the loads below write
        if constexpr (kInPlace) bulk_wait<0, true>();
      }
      const Item w = item_of(it, chunks, L);
      mbar_arrive_expect_tx(&full[s], bytes);
      tma_load_4d(t, &q_map, &full[s], w.chunk * CW, w.pos, 0, w.b);
      tma_load_4d(t + TILE, &k_map, &full[s], w.chunk * CW, w.pos, 0, w.b);
      tma_load_4d(t + 2 * TILE, &v_map, &full[s], w.chunk * CW, w.pos, 0, w.b);
      tma_load_4d(t + 3 * TILE, &g_map, &full[s], w.chunk * CW, w.pos, 0, w.b);
      if constexpr (!kInPlace) {
        bulk_wait<0, true>();  // the gradient tiles item n writes have been read
        mbar_arrive(&full[s]);
      }
    }
    for (int m = n > kStages ? n - kStages : 0; m < n; ++m) {
      const int s = m % kStages;
      mbar_wait(&empty[s], (m / kStages) & 1);
      store_item(item_of(blockIdx.x + m * gridDim.x, chunks, L), tiles + (size_t)s * STAGE,
                 otiles + (size_t)s * 3 * OTILE, dq, dk, dv, &dq_map, &dk_map, &dv_map, F, L, C,
                 CW, CWP, TILE, OTILE);
      bulk_commit();
    }
    bulk_wait<0, false>();
    return;
  }

  // consumers: task g = n * tasks + t of this block goes to warp g %
  // kConsumers; every warp waits for every item and frees it, so no warp
  // can be lapped by the ring
  bf16* own = scratch + (size_t)warp * kMaxFrames * LP;
  int n = 0;
  for (int it = blockIdx.x; it < items; it += gridDim.x, ++n) {
    const int s = n % kStages;
    mbar_wait(&full[s], (n / kStages) & 1);
    bf16* tq = tiles + (size_t)s * STAGE;
    bf16* tk = tq + TILE;
    bf16* tv = tq + 2 * TILE;
    bf16* tg = tq + 3 * TILE;
    bf16* ot = otiles + (size_t)s * 3 * OTILE;
    bf16* oq = kInPlace ? tg : ot;
    bf16* ok = kInPlace ? tk : ot + OTILE;
    bf16* ov = kInPlace ? tv : ot + 2 * OTILE;
    const int LDO = kInPlace ? CWP : CW;
    for (int t = (warp - (n * tasks) % kConsumers + kConsumers) % kConsumers; t < tasks;
         t += kConsumers) {
      const int off = t * d;
      head_grad<DP, MT>(tq + off, tk + off, tv + off, tg + off, CWP, oq + off, ok + off,
                        ov + off, LDO, own, F, d, scale_log2, scale, lane);
    }
    fence_proxy_async();  // the gradients' writes before the stores read them
    __syncwarp();
    if (lane == 0) mbar_arrive(&empty[s]);
  }
}

HostCache host_cache;

template <int DP, int MT>
int launch(const void* q, const void* k, const void* v, const void* g, void* dq, void* dk,
           void* dv, int B, int F, int L, int heads, int d, int CW, int CWP, int scale_d,
           cudaStream_t stream) {
  const int C = heads * d;
  CUtensorMap maps[7] = {};
  int err = make_map_4d(&maps[0], q, C, L, F, B, CWP, 1, F);
  if (!err) err = make_map_4d(&maps[1], k, C, L, F, B, CWP, 1, F);
  if (!err) err = make_map_4d(&maps[2], v, C, L, F, B, CWP, 1, F);
  if (!err) err = make_map_4d(&maps[3], g, C, L, F, B, CWP, 1, F);
  if (!kInPlace) {
    if (!err) err = make_map_4d(&maps[4], dq, C, L, F, B, CW, 1, F);
    if (!err) err = make_map_4d(&maps[5], dk, C, L, F, B, CW, 1, F);
    if (!err) err = make_map_4d(&maps[6], dv, C, L, F, B, CW, 1, F);
  }
  if (err) return err;
  const int bytes = (int)smem_bytes(F, CW, CWP);
  auto kernel = temporal_bwd_kernel<DP, MT>;
  const void* fn = reinterpret_cast<const void*>(kernel);
  cudaError_t e = host_cache.reserve_smem(fn, bytes);
  if (e != cudaSuccess) return (int)e;
  int slots = 0;  // blocks the card holds at once: the persistent grid
  e = host_cache.get(fn, bytes, 0, &slots, [&](int* value) {
    int dev = 0, sms = 0, per_sm = 0;
    cudaError_t r = cudaGetDevice(&dev);
    if (r == cudaSuccess) r = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (r == cudaSuccess)
      r = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads, bytes);
    *value = sms * per_sm;
    return r;
  });
  if (e != cudaSuccess) return (int)e;
  if (slots < 1) return (int)cudaErrorInvalidConfiguration;
  const long long items = (long long)B * L * (C / CW);
  const int grid = (int)(items < slots ? items : slots);
  const float scale = 1.f / sqrtf((float)scale_d);
  kernel<<<grid, kThreads, bytes, stream>>>(
      maps[0], maps[1], maps[2], maps[3], maps[4], maps[5], maps[6], static_cast<bf16*>(dq),
      static_cast<bf16*>(dk), static_cast<bf16*>(dv), B, F, L, C, d, CW, CWP, scale * kLog2e,
      scale);
  return (int)cudaGetLastError();
}

template <int DP>
int launch_frames(const void* q, const void* k, const void* v, const void* g, void* dq,
                  void* dk, void* dv, int B, int F, int L, int heads, int d, int CW, int CWP,
                  int scale_d, cudaStream_t s) {
  if (F <= 16) return launch<DP, 1>(q, k, v, g, dq, dk, dv, B, F, L, heads, d, CW, CWP,
                                    scale_d, s);
  return launch<DP, 2>(q, k, v, g, dq, dk, dv, B, F, L, heads, d, CW, CWP, scale_d, s);
}

// ---- heads wider than 160 columns: one head walked in column chunks --------
//
// An item is kWideConsumers positions x all F frames x one head of d > 160
// columns, walked in `chunks` chunks of CW columns (the last d - (chunks -
// 1) * CW); a consumer warp a position. A stage holds one chunk in four
// slots (Q, K, V, G) of kWideConsumers tiles [F][CWP]. The producer walks
// each item in 2 * chunks steps:
//   steps 0 .. chunks-1: Q, K, V and G of chunk c; each warp adds Q_c K_c^T
//     to its position's S and G_c V_c^T to its dP (f x f each, in
//     registers: the whole head's sums before the softmax);
//   then P, delta and dS, once an item, in registers;
//   steps chunks .. 2*chunks-1: Q, K and G of chunk c again (V is not
//     needed); each warp writes dV_c = P^T G_c into the V slot (not
//     loaded), dQ_c = dS K_c over G_c and dK_c = dS^T Q_c over K_c, and the
//     producer stores them, one bulk copy per (gradient, position, frame
//     row), when the stage comes back, before reloading it.
// The second pass reads q, k and g again (7 tensor reads where the least is
// 4, from L2 while the item's chunks stay there); an f x f sum is all that
// crosses chunks. Four slots of two positions at f = 32 and 168 columns are
// 86 KB a stage: two stages, one block an SM. Columns past a chunk and
// frames past F are removed by selects as at d <= 160; positions past L
// are neither loaded nor stored. No atomics: the same inputs give the same
// bits.
constexpr int kWideConsumers = 2;  // consumer warps of a wide item, one position each
constexpr int kWideStages = 2;
constexpr int kWideThreads = 32 * (kWideConsumers + 1);
constexpr int kChunkColumns = 160;  // the widest chunk (the wrapper's CHUNK_COLUMNS)
constexpr int kPiece = 64;          // columns of one partial sum of S and dP

// The stages' four slots of kWideConsumers tiles, the room past them, the
// warps' transpose tiles, the mbarriers.
__host__ __device__ inline size_t wide_smem_bytes(int F, int cwp) {
  return 128 +
         ((size_t)kWideStages * 4 * kWideConsumers * tile_elems(F, cwp) +
          (size_t)room_elems(F, cwp) +
          (kMovmatrix ? 0 : (size_t)kWideConsumers * kMaxFrames * LP)) * 2 +
         2 * kWideStages * 8;
}

template <int MT>
__global__ void __launch_bounds__(kWideThreads)
temporal_bwd_wide_kernel(const __grid_constant__ CUtensorMap q_map,
                         const __grid_constant__ CUtensorMap k_map,
                         const __grid_constant__ CUtensorMap v_map,
                         const __grid_constant__ CUtensorMap g_map, bf16* __restrict__ dq,
                         bf16* __restrict__ dk, bf16* __restrict__ dv, int B, int F, int L,
                         int C, int d, int CW, int CWP, int chunks, float scale_log2,
                         float scale) {
  constexpr int P = kWideConsumers, S = kWideStages;
  extern __shared__ unsigned char smem_raw[];
  bf16* tiles = reinterpret_cast<bf16*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 127) & ~static_cast<uintptr_t>(127));
  const int TILE = tile_elems(F, CWP);
  const int SLOT = P * TILE, STAGE = 4 * SLOT;  // Q, K, V, G
  bf16* scratch = tiles + (size_t)S * STAGE + room_elems(F, CWP);
  uint64_t* full = reinterpret_cast<uint64_t*>(
      scratch + (kMovmatrix ? 0 : (size_t)P * kMaxFrames * LP));
  uint64_t* empty = full + S;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int heads = C / d;
  const int pblocks = (L + P - 1) / P;
  const int items = B * pblocks * heads;
  const int steps = 2 * chunks;

  if (threadIdx.x == 0) {
    for (int s = 0; s < S; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], P);
    }
    fence_barrier_init();
  }
  __syncthreads();

  if (warp == P) {
    // producer (one thread)
    if (lane != 0) return;
    // the gradients of step m (a second-pass step) leave their stage: dQ
    // from the G slot, dK from the K slot, dV from the V slot
    auto store = [&](int m) {
      const int it = blockIdx.x + (m / steps) * gridDim.x, c = m % steps - chunks;
      const int h = it % heads, pos0 = ((it / heads) % pblocks) * P, b = it / (heads * pblocks);
      const bf16* t = tiles + (size_t)(m % S) * STAGE;
      const bf16* src[3] = {t + 3 * SLOT, t + SLOT, t + 2 * SLOT};
      bf16* dst[3] = {dq, dk, dv};
      const int dc = min(CW, d - c * CW);
#pragma unroll
      for (int i = 0; i < 3; ++i)
        for (int p = 0; p < P && pos0 + p < L; ++p)
          for (int r = 0; r < F; ++r)
            bulk_store(dst[i] + (((size_t)b * F + r) * L + pos0 + p) * C + (size_t)h * d + c * CW,
                       src[i] + (size_t)p * TILE + (size_t)r * CWP, (uint32_t)dc * 2);
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
            bulk_wait<0, true>();  // the gradients are read before the stage is loaded again
          }
        }
        const bool first = j < chunks;  // the first pass loads V too
        const int col = h * d + (j % chunks) * CW;
        mbar_arrive_expect_tx(&full[s], (first ? 4u : 3u) * valid * F * CWP * 2);
        for (int p = 0; p < valid; ++p) {
          const int pos = pos0 + p;
          bf16* tp = t + (size_t)p * TILE;
          tma_load_4d(tp, &q_map, &full[s], col, pos, 0, b);
          tma_load_4d(tp + SLOT, &k_map, &full[s], col, pos, 0, b);
          if (first) tma_load_4d(tp + 2 * SLOT, &v_map, &full[s], col, pos, 0, b);
          tma_load_4d(tp + 3 * SLOT, &g_map, &full[s], col, pos, 0, b);
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
  bf16* own = scratch + (size_t)warp * kMaxFrames * LP;
  int n = 0;
  for (int it = blockIdx.x; it < items; it += gridDim.x) {
    float p[MT][2 * MT][4], dp[MT][2 * MT][4];
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int j = 0; j < 2 * MT; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) p[mt][j][e] = dp[mt][j][e] = 0.f;
    for (int c = 0; c < chunks; ++c, ++n) {
      const int s = n % S;
      mbar_wait(&full[s], (n / S) & 1);
      const bf16* t = tiles + (size_t)s * STAGE + (size_t)warp * TILE;
      const int dc = min(CW, d - c * CW);
      // the sums over each kPiece columns start from zero and are added in
      // fp32 after: the tensor cores' accumulation, not rounded to nearest,
      // then spans at most 4 16-deep steps (at d = 1280 one accumulator over
      // the head read 2x the d <= 160 kernel's error against the plain
      // version)
      for (int off = 0; off < dc; off += kPiece) {
        float pc[MT][2 * MT][4], dpc[MT][2 * MT][4];
        const int w = min(kPiece, dc - off);
        rows_by_rows<kPiece, MT>(pc, t + off, t + SLOT + off, CWP, w, lane);  // Q K^T
        rows_by_rows<kPiece, MT>(dpc, t + 3 * SLOT + off, t + 2 * SLOT + off, CWP, w,
                                 lane);  // G V^T
#pragma unroll
        for (int mt = 0; mt < MT; ++mt)
#pragma unroll
          for (int j = 0; j < 2 * MT; ++j)
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              p[mt][j][e] += pc[mt][j][e];
              dp[mt][j][e] += dpc[mt][j][e];
            }
      }
      __syncwarp();
      if (lane == 0) mbar_arrive(&empty[s]);
    }
    uint32_t pa[MT][MT][4], da[MT][MT][4];
    probs_and_ds<MT>(p, dp, pa, da, F, scale_log2, lane);
    for (int c = 0; c < chunks; ++c, ++n) {
      const int s = n % S;
      mbar_wait(&full[s], (n / S) & 1);
      bf16* t = tiles + (size_t)s * STAGE + (size_t)warp * TILE;
      grads_store<kChunkColumns, MT>(pa, da, t, t + SLOT, t + 3 * SLOT, CWP, t + 3 * SLOT,
                                     t + SLOT, t + 2 * SLOT, CWP, own, F, min(CW, d - c * CW),
                                     scale, lane);
      fence_proxy_async();  // the gradients' writes before the bulk copies read them
      __syncwarp();
      if (lane == 0) mbar_arrive(&empty[s]);
    }
  }
}

template <int MT>
int launch_wide(const void* q, const void* k, const void* v, const void* g, void* dq, void* dk,
                void* dv, int B, int F, int L, int heads, int d, int CW, int CWP, int chunks,
                int scale_d, cudaStream_t stream) {
  const int C = heads * d;
  CUtensorMap maps[4];
  int err = make_map_4d(&maps[0], q, C, L, F, B, CWP, 1, F);
  if (!err) err = make_map_4d(&maps[1], k, C, L, F, B, CWP, 1, F);
  if (!err) err = make_map_4d(&maps[2], v, C, L, F, B, CWP, 1, F);
  if (!err) err = make_map_4d(&maps[3], g, C, L, F, B, CWP, 1, F);
  if (err) return err;
  const int bytes = (int)wide_smem_bytes(F, CWP);
  auto kernel = temporal_bwd_wide_kernel<MT>;
  const void* fn = reinterpret_cast<const void*>(kernel);
  cudaError_t e = host_cache.reserve_smem(fn, bytes);
  if (e != cudaSuccess) return (int)e;
  int slots = 0;  // blocks the card holds at once: the persistent grid
  e = host_cache.get(fn, bytes, 0, &slots, [&](int* value) {
    int dev = 0, sms = 0, per_sm = 0;
    cudaError_t r = cudaGetDevice(&dev);
    if (r == cudaSuccess) r = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (r == cudaSuccess)
      r = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kWideThreads, bytes);
    *value = sms * per_sm;
    return r;
  });
  if (e != cudaSuccess) return (int)e;
  if (slots < 1) return (int)cudaErrorInvalidConfiguration;
  const long long items = (long long)B * ((L + kWideConsumers - 1) / kWideConsumers) * heads;
  const int grid = (int)(items < slots ? items : slots);
  const float scale = 1.f / sqrtf((float)scale_d);
  kernel<<<grid, kWideThreads, bytes, stream>>>(
      maps[0], maps[1], maps[2], maps[3], static_cast<bf16*>(dq), static_cast<bf16*>(dk),
      static_cast<bf16*>(dv), B, F, L, C, d, CW, CWP, chunks, scale * kLog2e, scale);
  return (int)cudaGetLastError();
}

// ---- more than 32 frames: the long kernel -----------------------------------
//
// Past 32 frames a row's softmax no longer fits a warp's two 16-row tiles,
// and the transposes (LP, movmatrix) are sized for 32 frames. So a block of
// kLongWarps warps owns one (sample, position, head), all f frames, and
// takes it in three phases over query and key tiles of 16 frames, each
// product over the head's depth in kPiece-column pieces (copied to the
// warp's own tiles by cp.async, zeros past f and past the piece):
//   1. per query tile: the row max and sum of S = Q K^T * scale (one sweep
//      over the key tiles, the sum rescaled to the running max), then
//      delta = rowsum(P * dP), dP = G V^T, P normalized (a second sweep);
//      the three words of every row go to shared memory;
//   2. per (query tile, slab of kPiece columns): dQ = dS K * scale, with
//      P and dP recomputed per key tile and dS = P (dP - delta) rounded to
//      bf16, as the plain version rounds it;
//   3. per (key tile, slab): dV = P^T G and dK = dS^T Q * scale, from S^T =
//      K Q^T and dP^T = V G^T recomputed per query tile, the words of the
//      tile's query columns read from shared memory (query columns >= f
//      get P = 0).
// Each gradient element is written by one warp, with no atomics: the same
// inputs give the same bits. Recomputation costs operations (S three times,
// dP twice, once more per extra slab), which the bytes still bound.
constexpr int kLongWarps = 4;
constexpr int kLongTiles = 4;  // shared tiles of a warp: two product operands, two slabs

__host__ __device__ inline size_t long_smem_bytes(int F) {
  return (size_t)kLongWarps * kLongTiles * 16 * tiles::kLd * 2 +
         (size_t)3 * ((F + 15) / 16 * 16) * 4;
}

__global__ void __launch_bounds__(32 * kLongWarps)
temporal_bwd_long_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                         const bf16* __restrict__ v, const bf16* __restrict__ g,
                         bf16* __restrict__ dq, bf16* __restrict__ dk, bf16* __restrict__ dv,
                         int F, int L, int heads, int d, float scale_log2, float scale) {
  extern __shared__ __align__(128) unsigned char long_smem[];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int QT = (F + 15) / 16, FP = QT * 16, slabs = (d + tiles::kPiece - 1) / tiles::kPiece;
  bf16* t0 = reinterpret_cast<bf16*>(long_smem) + (size_t)warp * kLongTiles * 16 * tiles::kLd;
  bf16* t1 = t0 + 16 * tiles::kLd;
  bf16* t2 = t1 + 16 * tiles::kLd;
  bf16* t3 = t2 + 16 * tiles::kLd;
  float* row_max = reinterpret_cast<float*>(reinterpret_cast<bf16*>(long_smem) +
                                            (size_t)kLongWarps * kLongTiles * 16 * tiles::kLd);
  float* row_inv = row_max + FP;
  float* row_delta = row_inv + FP;
  const int h = blockIdx.x % heads, l = (blockIdx.x / heads) % L, b = blockIdx.x / (heads * L);
  const int C = heads * d;
  const size_t fs = (size_t)L * C;                                  // elements between frames
  const size_t base = ((size_t)b * F * L + l) * C + (size_t)h * d;  // (b, frame 0, l, head h)

  // s = X Y^T over the head's depth: rows xt*16.. of x against rows yt*16.. of y
  auto product = [&](float (&s)[2][4], const bf16* x, int xt, const bf16* y, int yt) {
    tiles::frames_product(s, x + base, xt, y + base, yt, fs, F, d, t0, t1, lane);
  };
  // S of query tile qt against key tile kt, log2 domain, keys >= F at -inf
  auto logits = [&](float (&s)[2][4], int qt, int kt) {
    product(s, q, qt, k, kt);
    tiles::scale_mask_keys(s, kt, F, scale_log2, lane);
  };

  // 1. the words of every row: max, 1 / sum, delta
  for (int qt = warp; qt < QT; qt += kLongWarps) {
    float m[2] = {-INFINITY, -INFINITY}, lsum[2] = {0.f, 0.f};
    for (int kt = 0; kt < QT; ++kt) {
      float s[2][4];
      logits(s, qt, kt);
      tiles::row_stats(s, m, lsum);
    }
    const float inv[2] = {1.f / tiles::quad_sum(lsum[0]), 1.f / tiles::quad_sum(lsum[1])};
    float delta[2] = {0.f, 0.f};
    for (int kt = 0; kt < QT; ++kt) {
      float s[2][4], dp[2][4];
      logits(s, qt, kt);
      product(dp, g, qt, v, kt);
#pragma unroll
      for (int j = 0; j < 2; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          delta[e >> 1] += exp2f(s[j][e] - m[e >> 1]) * inv[e >> 1] * dp[j][e];
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      delta[r] = tiles::quad_sum(delta[r]);
      if (lane % 4 == 0) {
        const int row = qt * 16 + lane / 4 + 8 * r;
        row_max[row] = m[r];
        row_inv[row] = inv[r];
        row_delta[row] = delta[r];
      }
    }
  }
  __syncthreads();

  // 2. dQ, per (query tile, slab)
  for (int t = warp; t < QT * slabs; t += kLongWarps) {
    const int qt = t % QT, c0 = (t / QT) * tiles::kPiece, w = min(tiles::kPiece, d - c0);
    float m[2], inv[2], delta[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = qt * 16 + lane / 4 + 8 * r;
      m[r] = row_max[row];
      inv[r] = row_inv[row];
      delta[r] = row_delta[row];
    }
    float acc[tiles::kPiece / 8][4];
    tiles::zero(acc);
    for (int kt = 0; kt < QT; ++kt) {
      // K's slab lands under the products' loads (their waits cover it)
      tiles::load_rows_async<16>(t2, tiles::kLd, k + base + c0, fs, kt * 16, F, w, lane, 32);
      float s[2][4], dp[2][4];
      logits(s, qt, kt);
      product(dp, g, qt, v, kt);
#pragma unroll
      for (int j = 0; j < 2; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float p = exp2f(s[j][e] - m[e >> 1]) * inv[e >> 1];
          s[j][e] = p * (dp[j][e] - delta[e >> 1]);
        }
      uint32_t a[4];
      tiles::pack_a(a, s[0], s[1]);
      tiles::mma_av<tiles::kPiece / 8>(acc, a, t2, tiles::kLd, tiles::round16(w) / 16, lane);
      __syncwarp();
    }
    const float mul[2] = {scale, scale};
    tiles::store_acc<tiles::kPiece / 8>(dq + base + c0, fs, acc, qt * 16, F, w, mul, lane);
  }

  // 3. dK and dV, per (key tile, slab)
  for (int t = warp; t < QT * slabs; t += kLongWarps) {
    const int kt = t % QT, c0 = (t / QT) * tiles::kPiece, w = min(tiles::kPiece, d - c0);
    float acc_k[tiles::kPiece / 8][4], acc_v[tiles::kPiece / 8][4];
    tiles::zero(acc_k);
    tiles::zero(acc_v);
    for (int qt = 0; qt < QT; ++qt) {
      tiles::load_rows_async<16>(t2, tiles::kLd, g + base + c0, fs, qt * 16, F, w, lane, 32);
      tiles::load_rows_async<16>(t3, tiles::kLd, q + base + c0, fs, qt * 16, F, w, lane, 32);
      float st[2][4], dpt[2][4];
      product(st, k, kt, q, qt);   // S^T: rows keys, columns queries
      product(dpt, v, kt, g, qt);  // dP^T
#pragma unroll
      for (int j = 0; j < 2; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int col = qt * 16 + 8 * j + 2 * (lane % 4) + (e & 1);
          float p = 0.f, ds = 0.f;
          if (col < F) {
            p = exp2f(st[j][e] * scale_log2 - row_max[col]) * row_inv[col];
            ds = p * (dpt[j][e] - row_delta[col]);
          }
          st[j][e] = p;
          dpt[j][e] = ds;
        }
      uint32_t a[4];
      tiles::pack_a(a, st[0], st[1]);
      tiles::mma_av<tiles::kPiece / 8>(acc_v, a, t2, tiles::kLd, tiles::round16(w) / 16, lane);
      tiles::pack_a(a, dpt[0], dpt[1]);
      tiles::mma_av<tiles::kPiece / 8>(acc_k, a, t3, tiles::kLd, tiles::round16(w) / 16, lane);
      __syncwarp();
    }
    const float one[2] = {1.f, 1.f}, mul[2] = {scale, scale};
    tiles::store_acc<tiles::kPiece / 8>(dv + base + c0, fs, acc_v, kt * 16, F, w, one, lane);
    tiles::store_acc<tiles::kPiece / 8>(dk + base + c0, fs, acc_k, kt * 16, F, w, mul, lane);
  }
}

int launch_long(const void* q, const void* k, const void* v, const void* g, void* dq, void* dk,
                void* dv, int B, int F, int L, int heads, int d, int scale_d,
                cudaStream_t stream) {
  const long long blocks = (long long)B * L * heads;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  const int bytes = (int)long_smem_bytes(F);
  const void* fn = reinterpret_cast<const void*>(temporal_bwd_long_kernel);
  cudaError_t e = host_cache.reserve_smem(fn, bytes);
  if (e != cudaSuccess) return (int)e;
  const float scale = 1.f / sqrtf((float)scale_d);
  temporal_bwd_long_kernel<<<(unsigned)blocks, 32 * kLongWarps, bytes, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<const bf16*>(g), static_cast<bf16*>(dq), static_cast<bf16*>(dk),
      static_cast<bf16*>(dv), F, L, heads, d, scale * kLog2e, scale);
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
// multiple of 8 up to 1280 runs in the long kernel, with the forward's plan
// (heads_per_item = 1, chunks = ceil(d / tiles::kPiece), cwp = tiles::kLd).
extern "C" int hv_temporal_bwd(const void* q, const void* k, const void* v, const void* g,
                               void* dq, void* dk, void* dv, int B, int F, int L, int heads,
                               int d, int heads_per_item, int cwp, int chunks, int scale_d,
                               void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (F > kMaxFrames) {
    if (B < 1 || L < 1 || d <= 0 || d % 8 != 0 || d > 8 * kChunkColumns || heads < 1 ||
        heads_per_item != 1 || cwp != tiles::kLd ||
        chunks != (d + tiles::kPiece - 1) / tiles::kPiece || scale_d < 1 || scale_d > d ||
        (long long)B * heads * d * F * L >= (1LL << 40))
      return (int)cudaErrorInvalidValue;
    return launch_long(q, k, v, g, dq, dk, dv, B, F, L, heads, d, scale_d, s);
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
    if (F <= 16)
      return launch_wide<1>(q, k, v, g, dq, dk, dv, B, F, L, heads, d, CW, cwp, chunks, scale_d,
                            s);
    return launch_wide<2>(q, k, v, g, dq, dk, dv, B, F, L, heads, d, CW, cwp, chunks, scale_d,
                          s);
  }
#define FRAMES(DP) \
  launch_frames<DP>(q, k, v, g, dq, dk, dv, B, F, L, heads, d, CW, cwp, scale_d, s)
  if (d <= 48) return FRAMES(48);
  if (d <= 80) return FRAMES(80);
  if (d <= 160) return FRAMES(160);
#undef FRAMES
  return (int)cudaErrorInvalidValue;
}

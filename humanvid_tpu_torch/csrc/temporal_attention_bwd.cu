// Frame-axis (temporal) multi-head attention backward, bf16, for Hopper (sm_90a).
//
// Replaces: humanvid_tpu/ops/temporal_attention.py, the Pallas kernel
// `_bwd_kernel`, launched by `_call_bwd` through `_temporal_bwd`.
//
// Computes, for each (b, position l, head h), the gradient of
//   out = softmax_over_frames(q k^T * d^-1/2) v
// (the forward of csrc/temporal_attention.cu) given g = dL/dout, on
// q/k/v/g/dq/dk/dv of shape (b, f, l, c) with heads packed in c, f <= 32
// (more: the frames kernel up to 128 frames, the long kernel past them, near
// the end of this file):
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
#include "temporal_split.cuh"
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
constexpr int kChunkColumns = 160;  // the widest item (the wrapper's CHUNK_COLUMNS)
constexpr int kPiece = 64;          // columns of one partial sum of S and dP
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

// ---- heads wider than 160 columns: one head split in column slices ---------
//
// Replaces, for 160 < d <= 1280 at f <= 32: the same Pallas kernel
// `_bwd_kernel` (humanvid_tpu/ops/temporal_attention.py:116), whose block
// holds a head of any width.
//
// What bounds it on the H100: device-memory bytes, as at d <= 160. At the
// heads64 stage-2 step's level 2 (1,24,448,1280), d = 256, a call reads q,
// k, v and g and writes dq, dk and dv, 193 MB (58 us at 3.35 TB/s), against
// 2.6 GFLOP. The first design of these heads (column chunks: 2 consumer warps a
// position each, one warp walking all of a head's chunks twice in
// sequence, q, k and g read again through a 2-stage ring, the gradients
// stored by a bulk copy a frame row from one producer thread that waited
// for its own stores before every reload) reached 30-43% of that bound.
//
// What this design does about it (the forward's split item,
// csrc/temporal_split.cuh):
// - The head's columns are spread over split::kWarps consumer warps, a
//   warp a (position, slice); the parts of S = Q K^T and dP = G V^T are
//   summed through shared memory in slice order, then each warp takes P,
//   delta and dS (`probs_and_ds`) and its slice of dV = P^T G, dQ = dS K *
//   scale and dK = dS^T Q * scale, each written over the tile it is
//   computed from and stored by one 5-D TMA store a warp; a warp waits for
//   a store to read its slot only once it has issued the next one.
// - The ring's unit is one tensor of an item. Where 6 slots fit
//   (kModeSplit: f <= 16 at every width), an item's Q, K, V and G are
//   loaded once and kept for the second sweep: V's slot goes back after
//   dP, G's, K's and Q's once the gradient written over each has been read
//   by its stores. Where they do not (kModeSplitStreamed), the second sweep
//   loads G, K and Q again (from L2: the item's first loads are a few
//   microseconds old) into slots of their own, and the first sweep's four
//   go back as soon as S's and dP's parts are taken, so the next item's
//   loads run under this item's second sweep.
// - Loads come from maps whose columns past the head read zeros; rows past
//   f, the columns past a slice and P and dS at frames past f are removed
//   by selects, so an Inf in another head or position reaches no gradient
//   of this one.
// No atomics: a repeat launch gives the same bits. At one frame P = 1 and
// dS = 0 exactly: dq = dk = 0 and dv = g.

// y = the A fragments of X^T, for x the A fragments of X (16 MT square).
template <int MT>
__device__ __forceinline__ void transpose_frags(const uint32_t (&x)[MT][MT][4],
                                                uint32_t (&y)[MT][MT][4]) {
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
}

// Threads of a block: the consumers and the producer. Each consumer stores
// its own gradients: a store warp, as the forward's, was 11-16% slower in
// turns on the H100 at d 320-1280 and 6% faster at d 256: PERF.md section
// 6, the split kernels' finding.
constexpr int kSplitThreads = 32 * (split::kWarps + 1);

// grid: persistent, at most one block per item; block kSplitThreads.
// Items are (sample, block of `positions` positions, head), tiles 16 MT
// frames tall in the mma (MT = 1 at f <= 16). An item is 4 loads (Q, K, V,
// G) kept for both sweeps, or STREAMED 7 (Q, K, V, G, then G, K, Q again),
// and 3 outputs: dV over (the second) G, dQ over K, dK over Q.
template <int MT, bool STREAMED>
__global__ void __launch_bounds__(kSplitThreads, 1)
temporal_bwd_split_kernel(const __grid_constant__ CUtensorMap q_map,
                          const __grid_constant__ CUtensorMap k_map,
                          const __grid_constant__ CUtensorMap v_map,
                          const __grid_constant__ CUtensorMap g_map,
                          const __grid_constant__ CUtensorMap dq_map,
                          const __grid_constant__ CUtensorMap dq_last_map,
                          const __grid_constant__ CUtensorMap dk_map,
                          const __grid_constant__ CUtensorMap dk_last_map,
                          const __grid_constant__ CUtensorMap dv_map,
                          const __grid_constant__ CUtensorMap dv_last_map, int B, int F, int L,
                          int heads, int d, int CW, int CWP, int slices, int positions,
                          int stages, float scale_log2, float scale) {
  constexpr int kLoads = STREAMED ? 7 : 4;  // tensor loads an item
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
    fence_barrier_init();
  }
  __syncthreads();

  if (warp == split::kWarps) {
    // producer (one thread): an item's tensors a slot each, in order; a
    // slot is loaded once every warp has freed its previous tensor
    if (lane != 0) return;
    const CUtensorMap* maps[7] = {&q_map, &k_map, &v_map, &g_map, &g_map, &k_map, &q_map};
    const uint32_t slot_bytes = (uint32_t)warps * F * CWP * 2;
    int n = 0;
    for (long long it = blockIdx.x; it < items; it += gridDim.x) {
      const int h = (int)(it % heads), l0 = (int)((it / heads) % pblocks) * positions;
      const int b = (int)(it / heads / pblocks);
      for (int t = 0; t < kLoads; ++t, ++n) {
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
  if (warp >= warps) return;

  // consumers: warp (p, sl) takes slice sl of position p of every item
  const int p = warp / slices, sl = warp % slices;
  const int dc = min(CW, d - sl * CW);  // the slice's columns
  const bool last = sl == slices - 1;
  const CUtensorMap* maps[3] = {last ? &dv_last_map : &dv_map, last ? &dq_last_map : &dq_map,
                                last ? &dk_last_map : &dk_map};
  int n = 0;                            // the item's first load
  // load i of the item: its tile, once it has landed; its slot freed
  auto tile = [&](int i) -> bf16* {
    const int s = (n + i) % stages;
    mbar_wait(&m.full[s], ((n + i) / stages) & 1);
    __syncwarp();
    return m.tiles + s * SLOT + (size_t)warp * TILE;
  };
  auto release = [&](int i) { mbar_arrive(&m.empty[(n + i) % stages]); };
  // output o of the item (dV, dQ, dK) written over `t`, which load i holds
  // (`row`: the position and head; `store`: the position is < L): the
  // warp stores it, and frees the slot of the output before it once that
  // one's store has read it, and its own at the last
  int row = 0, b = 0, prev = 0;
  bool store = false;
  auto written = [&](int o, const bf16* t, int i) {
    fence_proxy_async();  // the gradient's writes before its TMA store reads them
    __syncwarp();
    if (lane != 0) return;
    if (store) {
      tma_store_5d(maps[o], t, 0, last ? 0 : sl, row, 0, b);
      bulk_commit();
    }
    if (o > 0) {
      if (store) bulk_wait<1, true>();
      release(prev);
    }
    if (o == 2) {
      if (store) bulk_wait<0, true>();
      release(i);
    }
    prev = i;
  };
  for (long long it = blockIdx.x; it < items; it += gridDim.x, n += kLoads) {
    const int h = (int)(it % heads), l = (int)((it / heads) % pblocks) * positions + p;
    b = (int)(it / heads / pblocks);
    row = l * heads + h;
    store = l < L;
    float s[MT][2 * MT][4], dp[MT][2 * MT][4];
    bf16* tq = tile(0);
    bf16* tk = tile(1);
    split::partial_abt<MT>(s, tq, tk, CWP, dc, lane);  // Q K^T
    if constexpr (STREAMED) {
      __syncwarp();
      if (lane == 0) {
        release(0);
        release(1);
      }
    }
    bf16* tv = tile(2);
    bf16* tg = tile(3);
    split::partial_abt<MT>(dp, tg, tv, CWP, dc, lane);  // G V^T
    __syncwarp();
    if (lane == 0) {
      release(2);
      if constexpr (STREAMED) release(3);
    }
    split::exchange<MT>(s, m.xbuf, warp, p * slices, slices, 1 + p, lane);
    split::exchange<MT>(dp, m.xbuf, warp, p * slices, slices, 1 + p, lane);
    uint32_t pa[MT][MT][4], da[MT][MT][4], ta[MT][MT][4];
    probs_and_ds<MT>(s, dp, pa, da, F, scale_log2, lane);
    // dV = P^T G, over G
    transpose_frags<MT>(pa, ta);
    if constexpr (STREAMED) tg = tile(4);
    split::product_stage<MT>(ta, tg, CWP, tg, CWP, F, dc, 1.f, lane);
    written(0, tg, STREAMED ? 4 : 3);
    // dQ = dS K * scale, over K
    if constexpr (STREAMED) tk = tile(5);
    split::product_stage<MT>(da, tk, CWP, tk, CWP, F, dc, scale, lane);
    written(1, tk, STREAMED ? 5 : 1);
    // dK = dS^T Q * scale, over Q
    transpose_frags<MT>(da, ta);
    if constexpr (STREAMED) tq = tile(6);
    split::product_stage<MT>(ta, tq, CWP, tq, CWP, F, dc, scale, lane);
    written(2, tq, STREAMED ? 6 : 0);
  }
  if (lane == 0) bulk_wait<0, false>();
}

template <int MT, bool STREAMED>
int launch_split(const void* q, const void* k, const void* v, const void* g, void* dq, void* dk,
                 void* dv, int B, int F, int L, int heads, int d, int CW, int CWP, int slices,
                 int positions, int stages, int smem, int scale_d, cudaStream_t stream) {
  CUtensorMap maps[4], outs[3][2];
  const void* ins[4] = {q, k, v, g};
  void* grads[3] = {dq, dk, dv};
  int err = 0;
  for (int i = 0; i < 4 && !err; ++i)
    err = split::make_load_map(&maps[i], ins[i], d, heads, L, F, B, CWP);
  for (int i = 0; i < 3 && !err; ++i)
    err = split::make_store_maps(outs[i], grads[i], d, heads, L, F, B, slices, CW, CWP);
  if (err) return err;
  auto kernel = temporal_bwd_split_kernel<MT, STREAMED>;
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
  const float scale = 1.f / sqrtf((float)scale_d);
  kernel<<<grid, kSplitThreads, smem, stream>>>(
      maps[0], maps[1], maps[2], maps[3], outs[0][0], outs[0][1], outs[1][0], outs[1][1],
      outs[2][0], outs[2][1], B, F, L, heads, d, CW, CWP, slices, positions, stages,
      scale * kLog2e, scale);
  return (int)cudaGetLastError();
}

// ---- past the frames kernel's reach: the long kernel --------------------------
//
// Replaces, past FRAMES_KERNEL_FRAMES (128) frames: humanvid_tpu/ops/
// temporal_attention.py, the Pallas kernel `_bwd_kernel` (:116), which
// takes any frame count.
//
// What bounds it on the H100: device-memory bytes. At f = 136 the
// 128x128x136f step's shape at the size of level 0 (1,136,7168,320) reads
// q, k, v and g and writes dq, dk and dv, 4.4 GB (1.30 ms at 3.35 TB/s),
// against 4.0e11 operations (0.41 ms at the bf16 peak). The earlier long
// kernel (a block a (position, head), every product's operands copied
// again by cp.async for each warp) reached 3% of that bound; the frames kernel,
// which holds S and dP of a query tile's whole row in registers and P and
// dS of f x f frames in shared memory, spills past 7 tiles and cannot go
// further.
//
// What this design does about it:
// - A work item is one whole position, as the forward's: all f frames of
//   `per` whole heads, Q, K, V and G each read by one 4-D TMA box (f
//   rounded up to 16 frames tall, zeros past f) into a ring of `stages`
//   stages fed by a producer warp, over a persistent grid. Each tensor
//   leaves device memory once.
// - kLongConsumers consumer warps, however many frames, take the tasks of
//   each phase in turn, every product by `mma.sync.m16n8k16` from shared
//   memory, 16 x 16 tiles of S and dP at a time, straight-line code over
//   the head's 16-deep steps (a template constant: runtime loops there
//   kept the products of neighbouring tiles from overlapping, 1.5x slower):
//   A. per (query tile, head; at d <= 64 and half of the key tiles): S =
//      Q K^T and dP = G V^T, the running row max, the sum and the sum of
//      P * dP, both rescaled to the running max, gathered in one sweep;
//      the three words of every row (max, 1 / sum, delta = rowsum(P * dP):
//      f x 12 bytes a head) written, at d <= 64 after a named barrier from
//      the two halves' sums;
//   at d <= 64 (the motion modules' 40), per head and key panel of up to
//   kPanelTiles 16-frame tiles:
//   B. per (pair of query tiles, key tile of the panel): S and dP again, P
//      and dS = P (dP - delta), both rounded to bf16 as
//      `temporal_attention_backward_plain` rounds them, into shared memory
//      (f x panel each, not f x f);
//   C. after a named barrier, per key tile of the panel: dV = P^T G (even
//      warps) and dK = dS^T Q (odd) over every query tile in order, each
//      key row owned by one warp; and each warp's dQ += dS K for the query
//      tiles it holds (at most kHeldTiles, in registers, for the item);
//   past d = 64, where dQ of two tiles would not fit the registers:
//   B'. per (key tile, head, slab of at most 64 columns): S^T = K Q^T and
//      dP^T = V G^T over the query tiles, P^T from the words of each query
//      column, dS^T, then dV += P^T G and dK += dS^T Q of the slab;
//   C'. per (query tile, head, slab): S and dP a third time, dS, dQ += dS K.
//   A thread holds two 16 x 16 tiles of S and dP, the row words and its
//   gradients' tiles: registers do not grow with f, nor shared memory past
//   the row words and the f x panel P and dS.
// - Each gradient tile is staged in the warp's own tiles ([16][slab], two
//   of them) and written by one 5-D TMA store (d, heads, l, f, b), which
//   writes nothing past frame f or past the head's last column.
// - Large items (the plan's streamed mode, where Q, K, V and G of one head
//   do not fit one stage, as at f = 256 and d = 160, or for heads wider
//   than 160 columns): one head an item, its frames in panels of kPanel
//   frames and its columns in chunks of at most 64, a (query panel, key
//   panel, chunk) a stage (Q and G of the one, K and V of the other). Warp
//   w < kPanel / 16 owns tile w of the panel the phase walks (query tiles
//   in A and C, key tiles in B) and sums S and dP of the other panel over
//   the chunks in registers; the chunks of a gradient's pass are walked so
//   that its own chunk comes last, while the stage holds the operand of
//   its product. The row words of the whole item (f x 12 bytes, twice) sit
//   in shared memory; tiles are read again (from L2) for each panel pair.
// No atomics: the same inputs give the same bits, and each sample's and
// each head's gradients do not depend on the others'.
constexpr int kLongConsumers = 8;  // consumer warps
constexpr int kLongThreads = 32 * (kLongConsumers + 1);
constexpr int kPanel = 64;         // frames of a streamed panel
constexpr int kStreamWarps = kPanel / 16;  // consumer warps of a streamed item
constexpr int kLongMaxStages = 4;
constexpr int kLongChunk = 64;     // the widest column chunk of a streamed item
constexpr int kSlab = 64;          // the widest gradient slab of a resident item
// The plan's modes (`mode` of the entry point): the item kernels, the
// frames kernel, the long kernel with whole items, with streamed panels.
constexpr int kModeItems = 0, kModeFrames = 1, kModeResident = 2, kModeStreamed = 3;

// The resident items of heads at most kPanelWidth wide take P and dS
// through shared memory, kPanelTiles 16-frame key tiles at a time, in
// [FP][kPanelLd] bf16 tiles (a row of 144 bytes: an odd number of 16-byte
// units), and hold dQ of at most kHeldTiles query tiles a warp.
constexpr int kPanelWidth = 64;
constexpr int kPanelTiles = 4;
constexpr int kPanelLd = 16 * kPanelTiles + 8;
constexpr int kHeldTiles = 2;

// Bytes of shared memory the long backward lays out: `stages` x the Q, K,
// V and G tiles ([rows][cwp] bf16), the consumer warps' two staging tiles
// each ([16][ow]), `words` row words (fp32), `pds` elements of P and dS
// (bf16), the barriers and 128 bytes of alignment. `long_bwd_smem` in
// ops/temporal_attention.py reckons the same.
__host__ __device__ inline size_t long_bwd_smem(int rows, int cwp, int ow, int stages,
                                                int words, int pds) {
  return 128 + (size_t)stages * 4 * rows * cwp * 2 + (size_t)kLongConsumers * 2 * 16 * ow * 2 +
         (size_t)words * 4 + (size_t)pds * 2 + (size_t)stages * 16;
}

// The words of rows row0 + lane / 4 (+ 8) from the two halves' partial
// sums at w (max, sum and delta sum of half i at w[(3 i + k) stride + row]):
// max, 1 / sum, delta.
__device__ __forceinline__ void merge_words(float (&m)[2], float (&inv)[2], float (&delta)[2],
                                            const float* w, int stride, int row0, int lane) {
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + lane / 4 + 8 * r;
    const float m0 = w[row], m1 = w[3 * stride + row];
    const float mx = fmaxf(m0, m1), a0 = exp2f(m0 - mx), a1 = exp2f(m1 - mx);
    const float sum = w[stride + row] * a0 + w[4 * stride + row] * a1;
    m[r] = mx;
    inv[r] = 1.f / sum;
    delta[r] = (w[2 * stride + row] * a0 + w[5 * stride + row] * a1) / sum;
  }
}

// P and dS of the query tile whose first frame is row0 (this lane's rows
// row0 + lane / 4 (+ 8), their words m, inv, delta) against one key tile
// (first key key0), from S (s) and dP (dp): zero at query or key frames
// >= F, rounded to bf16 into columns col0.. of sp and sd ([..][kPanelLd]).
__device__ __forceinline__ void panel_tile(bf16* sp, bf16* sd, const float (&s)[2][4],
                                           const float (&dp)[2][4], const float (&m)[2],
                                           const float (&inv)[2], const float (&delta)[2],
                                           int row0, int key0, int col0, int F,
                                           float scale_log2, int lane) {
  const int row = row0 + lane / 4;
#pragma unroll
  for (int jj = 0; jj < 2; ++jj) {
    float pv[4], dv[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int r = e >> 1;
      const bool ok = key0 + 8 * jj + 2 * (lane % 4) + (e & 1) < F && row + 8 * r < F;
      const float pr = exp2f(s[jj][e] * scale_log2 - m[r]) * inv[r];
      pv[e] = ok ? pr : 0.f;
      dv[e] = ok ? pr * (dp[jj][e] - delta[r]) : 0.f;
    }
    const int col = col0 + 8 * jj + 2 * (lane % 4);
    *reinterpret_cast<uint32_t*>(sp + row * kPanelLd + col) = pack_bf16(pv[0], pv[1]);
    *reinterpret_cast<uint32_t*>(sp + (row + 8) * kPanelLd + col) = pack_bf16(pv[2], pv[3]);
    *reinterpret_cast<uint32_t*>(sd + row * kPanelLd + col) = pack_bf16(dv[0], dv[1]);
    *reinterpret_cast<uint32_t*>(sd + (row + 8) * kPanelLd + col) = pack_bf16(dv[2], dv[3]);
  }
}

// Partial sums of rows row0 + lane / 4 (+ 8) to w: max, sum, delta sum.
__device__ __forceinline__ void put_partial(float* w, int stride, int row0, const float (&m)[2],
                                            const float (&ls)[2], const float (&ds)[2],
                                            int lane) {
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const float sum = tiles::quad_sum(ls[r]), dsum = tiles::quad_sum(ds[r]);
    if (lane % 4 == 0) {
      const int row = row0 + lane / 4 + 8 * r;
      w[row] = m[r];
      w[stride + row] = sum;
      w[2 * stride + row] = dsum;
    }
  }
}

// o (16 rows x w columns) times mul to the warp's staging tile `k % 2` of
// buf ([2][16][w]), then one TMA store of it to the box at (c0, head, l,
// f0, b); a tile is written again only after its last store has read it.
template <int NT>
__device__ __forceinline__ void store_grad(bf16* buf, int& k, const CUtensorMap* map,
                                           const float (&o)[NT][4], int w, float mul, int c0,
                                           int head, int l, int f0, int b, int lane) {
  bf16* t = buf + (size_t)(k++ % 2) * 16 * w;
  if (lane == 0) bulk_wait<1, true>();
  __syncwarp();
  tiles::stage_rows<NT>(t, o, w, mul, lane);
  fence_proxy_async();  // the staging writes before the TMA store reads them
  __syncwarp();
  if (lane == 0) {
    tma_store_5d(map, t, c0, head, l, f0, b);
    bulk_commit();
  }
}

// One sweep step of phase A: the running max m, sum ls and delta sum ds of
// this lane's columns over one more 16 x 16 tile of S (log2 domain, keys
// >= F at -inf) and dP (keys >= F at 0), rescaled when m moves.
__device__ __forceinline__ void stats_step(const float (&s)[2][4], const float (&dp)[2][4],
                                           float (&m)[2], float (&ls)[2], float (&ds)[2]) {
  float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
  for (int j = 0; j < 2; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) mx[e >> 1] = fmaxf(mx[e >> 1], s[j][e]);
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const float mn = fmaxf(m[r], tiles::quad_max(mx[r]));
    const float corr = exp2f(m[r] - mn);
    ls[r] *= corr;
    ds[r] *= corr;
    m[r] = mn;
  }
#pragma unroll
  for (int j = 0; j < 2; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float p = exp2f(s[j][e] - m[e >> 1]);
      ls[e >> 1] += p;
      ds[e >> 1] += p * dp[j][e];
    }
}

// The words of rows row0 + lane / 4 (+ 8) from the sweep's sums: max,
// 1 / sum and delta, at w[0][row], w[1][row], w[2][row] (rows `stride`
// apart).
__device__ __forceinline__ void put_words(float* w, int stride, int row0, const float (&m)[2],
                                          const float (&ls)[2], const float (&ds)[2], int lane) {
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const float sum = tiles::quad_sum(ls[r]), delta = tiles::quad_sum(ds[r]) / sum;
    if (lane % 4 == 0) {
      const int row = row0 + lane / 4 + 8 * r;
      w[row] = m[r];
      w[stride + row] = 1.f / sum;
      w[2 * stride + row] = delta;
    }
  }
}

// Keys >= F of a 16 x 16 tile of dP to zero (key0 the tile's first key).
__device__ __forceinline__ void mask_keys(float (&dp)[2][4], int key0, int F, int lane) {
#pragma unroll
  for (int j = 0; j < 2; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e)
      if (key0 + 8 * j + 2 * (lane % 4) + (e & 1) >= F) dp[j][e] = 0.f;
}

// P^T and dS^T (A fragments pa, da) from S^T and dP^T of one key tile
// against the query tile whose first frame is q0: rows keys, columns
// queries, whose words come from w (rows `stride` apart); zero at queries
// >= F.
__device__ __forceinline__ void probs_t(uint32_t (&pa)[4], uint32_t (&da)[4], float (&st)[2][4],
                                        float (&dpt)[2][4], const float* w, int stride, int q0,
                                        int F, float scale_log2, int lane) {
#pragma unroll
  for (int j = 0; j < 2; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int q = q0 + 8 * j + 2 * (lane % 4) + (e & 1);
      float p = 0.f, ds = 0.f;
      if (q < F) {
        p = exp2f(st[j][e] * scale_log2 - w[q]) * w[stride + q];
        ds = p * (dpt[j][e] - w[2 * stride + q]);
      }
      st[j][e] = p;
      dpt[j][e] = ds;
    }
  tiles::pack_a(pa, st[0], st[1]);
  tiles::pack_a(da, dpt[0], dpt[1]);
}

// dS (A fragment da) from S and dP of the query tile whose row words are
// m, inv, delta against one key tile (first key key0): zero at keys >= F.
__device__ __forceinline__ void dscores(uint32_t (&da)[4], float (&s)[2][4], float (&dp)[2][4],
                                        const float (&m)[2], const float (&inv)[2],
                                        const float (&delta)[2], int key0, int F,
                                        float scale_log2, int lane) {
#pragma unroll
  for (int j = 0; j < 2; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int key = key0 + 8 * j + 2 * (lane % 4) + (e & 1);
      const int r = e >> 1;
      const float p = exp2f(s[j][e] * scale_log2 - m[r]) * inv[r];
      dp[j][e] = key < F ? p * (dp[j][e] - delta[r]) : 0.f;
    }
  tiles::pack_a(da, dp[0], dp[1]);
}

// The row words of rows row0 + lane / 4 (+ 8) from w (rows `stride` apart).
__device__ __forceinline__ void get_words(float (&m)[2], float (&inv)[2], float (&delta)[2],
                                          const float* w, int stride, int row0, int lane) {
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + lane / 4 + 8 * r;
    m[r] = w[row];
    inv[r] = w[stride + row];
    delta[r] = w[2 * stride + row];
  }
}

// grid: persistent, at most one block per item; block kLongThreads. Items
// are (sample, position, group of `per` heads), resident (KS: the 16-deep
// steps of a head, ceil(d / 16) or one more) or streamed (per = 1, chunks
// of CW columns); every tile is `rows` x CWP.
template <bool STREAMED, bool PANELS, int KS>
__global__ void __launch_bounds__(kLongThreads)
temporal_bwd_long_kernel(const __grid_constant__ CUtensorMap q_map,
                         const __grid_constant__ CUtensorMap k_map,
                         const __grid_constant__ CUtensorMap v_map,
                         const __grid_constant__ CUtensorMap g_map,
                         const __grid_constant__ CUtensorMap dq_map,
                         const __grid_constant__ CUtensorMap dk_map,
                         const __grid_constant__ CUtensorMap dv_map, int B, int F, int L,
                         int heads, int d, int per, int CW, int CWP, int chunks, int stages,
                         float scale_log2, float scale) {
  extern __shared__ unsigned char smem_raw[];
  bf16* tiles_ = reinterpret_cast<bf16*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 127) & ~static_cast<uintptr_t>(127));
  const int FP = (F + 15) / 16 * 16;
  const int NP = (F + kPanel - 1) / kPanel;  // panels of a streamed item
  const int ROWS = STREAMED ? kPanel : FP;
  const int TILE = ROWS * CWP, STAGE = 4 * TILE;  // Q, K, V, G
  const int OW = STREAMED ? CW : min(kSlab, d);   // columns a gradient tile
  const int WS = STREAMED ? NP * kPanel : FP;      // rows of a word array
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  bf16* staging = tiles_ + (size_t)stages * STAGE + (size_t)warp * 2 * 16 * OW;
  float* words = reinterpret_cast<float*>(tiles_ + (size_t)stages * STAGE +
                                          (size_t)kLongConsumers * 2 * 16 * OW);
  const int WORDS = STREAMED ? 2 * 3 * WS : stages * per * (PANELS ? 6 : 3) * WS;
  bf16* sp = reinterpret_cast<bf16*>(words + WORDS);  // P and dS of a key panel
  bf16* sd = sp + (size_t)FP * kPanelLd;
  uint64_t* full = reinterpret_cast<uint64_t*>(sp + (PANELS ? 2 * (size_t)FP * kPanelLd : 0));
  uint64_t* empty = full + stages;
  const int groups = heads / per;  // items of a position
  const long long items = (long long)B * L * groups;

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
    // then loads Q and G of the query frames, K and V of the key frames
    if (lane != 0) return;
    int n = 0;
    for (long long it = blockIdx.x; it < items; it += gridDim.x) {
      const int g = (int)(it % groups), l = (int)((it / groups) % L), b = (int)(it / groups / L);
      auto step = [&](int qf, int kf, int col) {
        const int s = n % stages;
        if (n >= stages) mbar_wait(&empty[s], ((n / stages) - 1) & 1);
        bf16* t = tiles_ + (size_t)s * STAGE;
        mbar_arrive_expect_tx(&full[s], 4u * TILE * 2);
        tma_load_4d(t, &q_map, &full[s], col, l, qf, b);
        tma_load_4d(t + TILE, &k_map, &full[s], col, l, kf, b);
        tma_load_4d(t + 2 * TILE, &v_map, &full[s], col, l, kf, b);
        tma_load_4d(t + 3 * TILE, &g_map, &full[s], col, l, qf, b);
        ++n;
      };
      if constexpr (!STREAMED) {
        step(0, 0, g * CW);
      } else {
        const int col0 = g * d;
        for (int qp = 0; qp < NP; ++qp)  // A
          for (int kp = 0; kp < NP; ++kp)
            for (int c = 0; c < chunks; ++c) step(qp * kPanel, kp * kPanel, col0 + c * CW);
        for (int kp = 0; kp < NP; ++kp)  // B
          for (int oc = 0; oc < chunks; ++oc)
            for (int qp = 0; qp < NP; ++qp)
              for (int j = 1; j <= chunks; ++j)
                step(qp * kPanel, kp * kPanel, col0 + (oc + j) % chunks * CW);
        for (int qp = 0; qp < NP; ++qp)  // C
          for (int oc = 0; oc < chunks; ++oc)
            for (int kp = 0; kp < NP; ++kp)
              for (int j = 1; j <= chunks; ++j)
                step(qp * kPanel, kp * kPanel, col0 + (oc + j) % chunks * CW);
      }
    }
    return;
  }

  int n = 0, staged = 0;
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

  if constexpr (!STREAMED && PANELS) {
    // the tasks of each phase go to the warps in turn, each phase's first
    // to the warp after the one that took the last phase's last; the
    // query tiles whose dQ a warp holds are fixed for an item
    const int QT = FP / 16;
    const int panels = (QT + kPanelTiles - 1) / kPanelTiles;
    const int PT = (QT + panels - 1) / panels;  // key tiles of a panel
    int base = 0;
    auto first = [&](int tasks) {
      const int t = (warp - base + kLongConsumers) % kLongConsumers;
      base = (base + tasks) % kLongConsumers;
      return t;
    };
    for (long long it = blockIdx.x; it < items; it += gridDim.x) {
      const int g = (int)(it % groups), l = (int)((it / groups) % L), b = (int)(it / groups / L);
      const int s = n % stages;
      const bf16* t = wait_step();
      const bf16 *tq = t, *tk = t + TILE, *tv = t + 2 * TILE, *tg = t + 3 * TILE;
      float* wd = words + (size_t)s * per * 6 * FP;
      // A. the row sums of each half of the key tiles
      const int half = (QT + 1) / 2;
      for (int task = first(QT * per * 2); task < QT * per * 2; task += kLongConsumers) {
        const int qt = task / (2 * per), h = (task / 2) % per, i = task % 2;
        const size_t qo = (size_t)qt * 16 * CWP + h * d;
        float m[2] = {-INFINITY, -INFINITY}, ls[2] = {0.f, 0.f}, ds[2] = {0.f, 0.f};
        for (int kt = i * half; kt < (i ? QT : half); ++kt) {
          const size_t ko = (size_t)kt * 16 * CWP + h * d;
          float sc[2][4], dp[2][4];
          tiles::tile_abt_k<KS>(sc, tq + qo, CWP, tk + ko, CWP, d, lane);
          tiles::tile_abt_k<KS>(dp, tg + qo, CWP, tv + ko, CWP, d, lane);
          tiles::scale_mask_keys(sc, 16 * kt, F, scale_log2, lane);
          mask_keys(dp, 16 * kt, F, lane);
          stats_step(sc, dp, m, ls, ds);
        }
        put_partial(wd + (size_t)(h * 2 + i) * 3 * FP, FP, 16 * qt, m, ls, ds, lane);
      }
      named_bar_sync(1, 32 * kLongConsumers);  // every row's partial sums written
      // the halves' sums merged into the words of each row (over half 0's)
      for (int task = first(QT * per); task < QT * per; task += kLongConsumers) {
        float* wr = wd + (size_t)(task % per) * 6 * FP;
        float m[2], inv[2], delta[2];
        merge_words(m, inv, delta, wr, FP, 16 * (task / per), lane);
        __syncwarp();
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const int row = 16 * (task / per) + lane / 4 + 8 * r;
          if (lane % 4 == 0) {
            wr[row] = m[r];
            wr[FP + row] = inv[r];
            wr[2 * FP + row] = delta[r];
          }
        }
      }
      named_bar_sync(1, 32 * kLongConsumers);  // every row's words written
      for (int h = 0; h < per; ++h) {
        const float* wh = wd + (size_t)h * 6 * FP;
        const int held0 = (warp - base + kLongConsumers) % kLongConsumers;  // first held tile
        float dq[kHeldTiles][2 * KS][4];
#pragma unroll
        for (int i = 0; i < kHeldTiles; ++i) tiles::zero(dq[i]);
        for (int p0 = 0; p0 < QT; p0 += PT) {
          const int pt = min(PT, QT - p0);
          // P and dS of every query tile against the panel's key tiles, a
          // pair of query tiles (K's and V's fragments loaded once) and a
          // key tile a task
          const int pairs = (QT + 1) / 2;
          for (int task = first(pairs * pt); task < pairs * pt; task += kLongConsumers) {
            const int qa = 2 * (task / pt), qb = min(qa + 1, QT - 1), j = task % pt;
            const int kt = p0 + j;
            const size_t ko = (size_t)kt * 16 * CWP + h * d;
            const size_t oa = (size_t)qa * 16 * CWP + h * d, ob = (size_t)qb * 16 * CWP + h * d;
            float sa[2][4], sb[2][4], da[2][4], db[2][4];
            tiles::tile_abt2_k<KS>(sa, sb, tq + oa, tq + ob, CWP, tk + ko, CWP, d, lane);
            tiles::tile_abt2_k<KS>(da, db, tg + oa, tg + ob, CWP, tv + ko, CWP, d, lane);
            float m[2], inv[2], delta[2];
            get_words(m, inv, delta, wh, FP, 16 * qa, lane);
            panel_tile(sp, sd, sa, da, m, inv, delta, 16 * qa, 16 * kt, 16 * j, F, scale_log2,
                       lane);
            if (qb != qa) {
              get_words(m, inv, delta, wh, FP, 16 * qb, lane);
              panel_tile(sp, sd, sb, db, m, inv, delta, 16 * qb, 16 * kt, 16 * j, F, scale_log2,
                         lane);
            }
          }
          named_bar_sync(1, 32 * kLongConsumers);  // the panel's P and dS whole
          // dV (even warps) and dK (odd) of the panel's key tiles, a warp
          // a tile: P^T G and dS^T Q over every query tile
          if (warp < 2 * pt) {
            const int j = warp / 2, kt = p0 + j;
            const bool is_v = warp % 2 == 0;
            const bf16* x = is_v ? sp : sd;
            const bf16* y = is_v ? tg : tq;
            float acc[2 * KS][4];
            tiles::zero(acc);
            for (int qt = 0; qt < QT; ++qt) {
              uint32_t a[4];
              ldmatrix_x4_trans(a, x + (16 * qt + 8 * (lane / 16) + lane % 8) * kPanelLd + 16 * j +
                                       8 * ((lane / 8) % 2));
              tiles::tile_av_k<KS>(acc, a, y + (size_t)qt * 16 * CWP + h * d, CWP, lane);
            }
            store_grad(staging, staged, is_v ? &dv_map : &dk_map, acc, OW, is_v ? 1.f : scale, 0,
                       g * per + h, l, 16 * kt, b, lane);
          }
          // dQ of the held query tiles += dS K over the panel's keys
#pragma unroll
          for (int i = 0; i < kHeldTiles; ++i) {
            const int qt = held0 + i * kLongConsumers;
            if (qt >= QT) break;
            for (int j = 0; j < pt; ++j) {
              uint32_t a[4];
              ldmatrix_x4(a, sd + (16 * qt + lane % 16) * kPanelLd + 16 * j + (lane / 16) * 8);
              tiles::tile_av_k<KS>(dq[i], a, tk + (size_t)(p0 + j) * 16 * CWP + h * d, CWP, lane);
            }
          }
          named_bar_sync(1, 32 * kLongConsumers);  // every read of the panel done
        }
#pragma unroll
        for (int i = 0; i < kHeldTiles; ++i) {
          const int qt = held0 + i * kLongConsumers;
          if (qt >= QT) break;
          store_grad(staging, staged, &dq_map, dq[i], OW, scale, 0, g * per + h, l, 16 * qt, b,
                     lane);
        }
      }
      free_step();
    }
  } else if constexpr (!STREAMED) {
    // the tasks of each phase go to the warps in turn, each phase's first
    // to the warp after the one that took the last phase's last
    const int QT = FP / 16, slabs = (d + OW - 1) / OW;
    int base = 0;
    auto first = [&](int tasks) {
      const int t = (warp - base + kLongConsumers) % kLongConsumers;
      base = (base + tasks) % kLongConsumers;
      return t;
    };
    for (long long it = blockIdx.x; it < items; it += gridDim.x) {
      const int g = (int)(it % groups), l = (int)((it / groups) % L), b = (int)(it / groups / L);
      const int s = n % stages;
      const bf16* t = wait_step();
      const bf16 *tq = t, *tk = t + TILE, *tv = t + 2 * TILE, *tg = t + 3 * TILE;
      float* wd = words + (size_t)s * per * 3 * FP;
      // A. the row words
      for (int task = first(QT * per); task < QT * per; task += kLongConsumers) {
        const int qt = task / per, h = task % per;
        const size_t qo = (size_t)qt * 16 * CWP + h * d;
        float m[2] = {-INFINITY, -INFINITY}, ls[2] = {0.f, 0.f}, ds[2] = {0.f, 0.f};
        for (int kt = 0; kt < QT; ++kt) {
          const size_t ko = (size_t)kt * 16 * CWP + h * d;
          float sc[2][4], dp[2][4];
          tiles::tile_abt_k<KS>(sc, tq + qo, CWP, tk + ko, CWP, d, lane);
          tiles::tile_abt_k<KS>(dp, tg + qo, CWP, tv + ko, CWP, d, lane);
          tiles::scale_mask_keys(sc, 16 * kt, F, scale_log2, lane);
          mask_keys(dp, 16 * kt, F, lane);
          stats_step(sc, dp, m, ls, ds);
        }
        put_words(wd + (size_t)h * 3 * FP, FP, 16 * qt, m, ls, ds, lane);
      }
      named_bar_sync(1, 32 * kLongConsumers);  // every row's words written
      // B. dV and dK, a key tile's slab a task
      for (int task = first(QT * per * slabs); task < QT * per * slabs;
           task += kLongConsumers) {
        const int kt = task / (per * slabs), h = (task / slabs) % per, c0 = (task % slabs) * OW;
        const size_t ko = (size_t)kt * 16 * CWP + h * d;
        const float* wh = wd + (size_t)h * 3 * FP;
        float acc_v[8][4], acc_k[8][4];
        tiles::zero(acc_v);
        tiles::zero(acc_k);
        for (int qt = 0; qt < QT; ++qt) {
          const size_t qo = (size_t)qt * 16 * CWP + h * d;
          float st[2][4], dpt[2][4];
          tiles::tile_abt_k<KS>(st, tk + ko, CWP, tq + qo, CWP, d, lane);
          tiles::tile_abt_k<KS>(dpt, tv + ko, CWP, tg + qo, CWP, d, lane);
          uint32_t pa[4], da[4];
          probs_t(pa, da, st, dpt, wh, FP, 16 * qt, F, scale_log2, lane);
          tiles::tile_av_k<4>(acc_v, pa, tg + qo + c0, CWP, lane);
          tiles::tile_av_k<4>(acc_k, da, tq + qo + c0, CWP, lane);
        }
        store_grad(staging, staged, &dv_map, acc_v, OW, 1.f, c0, g * per + h, l, 16 * kt, b,
                   lane);
        store_grad(staging, staged, &dk_map, acc_k, OW, scale, c0, g * per + h, l, 16 * kt, b,
                   lane);
      }
      // C. dQ, a query tile's slab a task
      for (int task = first(QT * per * slabs); task < QT * per * slabs;
           task += kLongConsumers) {
        const int qt = task / (per * slabs), h = (task / slabs) % per, c0 = (task % slabs) * OW;
        const size_t qo = (size_t)qt * 16 * CWP + h * d;
        float m[2], inv[2], delta[2];
        get_words(m, inv, delta, wd + (size_t)h * 3 * FP, FP, 16 * qt, lane);
        float acc_q[8][4];
        tiles::zero(acc_q);
        for (int kt = 0; kt < QT; ++kt) {
          const size_t ko = (size_t)kt * 16 * CWP + h * d;
          float sc[2][4], dp[2][4];
          tiles::tile_abt_k<KS>(sc, tq + qo, CWP, tk + ko, CWP, d, lane);
          tiles::tile_abt_k<KS>(dp, tg + qo, CWP, tv + ko, CWP, d, lane);
          uint32_t da[4];
          dscores(da, sc, dp, m, inv, delta, 16 * kt, F, scale_log2, lane);
          tiles::tile_av_k<4>(acc_q, da, tk + ko + c0, CWP, lane);
        }
        store_grad(staging, staged, &dq_map, acc_q, OW, scale, c0, g * per + h, l, 16 * qt, b,
                   lane);
      }
      free_step();
    }
  } else {
    // warp w owns tile w of the panel each phase walks
    if (warp >= kStreamWarps) return;
    int parity = 0;
    for (long long it = blockIdx.x; it < items; it += gridDim.x, parity ^= 1) {
      const int h = (int)(it % heads), l = (int)((it / heads) % L), b = (int)(it / heads / L);
      float* wd = words + (size_t)parity * 3 * WS;
      float sacc[kStreamWarps][2][4], dacc[kStreamWarps][2][4];
      // one step's products of the owned tile (rows 16 w of xa, ya) against
      // the other panel's four tiles (xb, yb), summed over the chunks
      auto products = [&](int c, const bf16* xa, const bf16* xb, const bf16* ya,
                          const bf16* yb, int wc) {
#pragma unroll
        for (int j = 0; j < kStreamWarps; ++j) {
          float p1[2][4], p2[2][4];
          tiles::tile_abt(p1, xa + (size_t)warp * 16 * CWP, CWP, xb + (size_t)j * 16 * CWP, CWP,
                          wc, lane);
          tiles::tile_abt(p2, ya + (size_t)warp * 16 * CWP, CWP, yb + (size_t)j * 16 * CWP, CWP,
                          wc, lane);
#pragma unroll
          for (int i = 0; i < 2; ++i)
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              sacc[j][i][e] = (c ? sacc[j][i][e] : 0.f) + p1[i][e];
              dacc[j][i][e] = (c ? dacc[j][i][e] : 0.f) + p2[i][e];
            }
        }
      };
      // A. the row words of the query tiles
      for (int qp = 0; qp < NP; ++qp) {
        float m[2] = {-INFINITY, -INFINITY}, ls[2] = {0.f, 0.f}, ds[2] = {0.f, 0.f};
        for (int kp = 0; kp < NP; ++kp)
          for (int c = 0; c < chunks; ++c) {
            const bf16* t = wait_step();
            products(c, t, t + TILE, t + 3 * TILE, t + 2 * TILE, min(CW, d - c * CW));
            if (c == chunks - 1) {
#pragma unroll
              for (int j = 0; j < kStreamWarps; ++j) {
                tiles::scale_mask_keys(sacc[j], kp * kPanel + 16 * j, F, scale_log2, lane);
                mask_keys(dacc[j], kp * kPanel + 16 * j, F, lane);
                stats_step(sacc[j], dacc[j], m, ls, ds);
              }
            }
            free_step();
          }
        put_words(wd, WS, qp * kPanel + 16 * warp, m, ls, ds, lane);
      }
      named_bar_sync(1, 32 * kStreamWarps);  // every row's words written
      // B. dV and dK of the key tiles, a chunk a pass
      for (int kp = 0; kp < NP; ++kp) {
        const int k0 = kp * kPanel + 16 * warp;
        for (int oc = 0; oc < chunks; ++oc) {
          const int wo = min(CW, d - oc * CW);
          float acc_v[8][4], acc_k[8][4];
          tiles::zero(acc_v);
          tiles::zero(acc_k);
          for (int qp = 0; qp < NP; ++qp)
            for (int j = 1; j <= chunks; ++j) {
              const int c = (oc + j) % chunks;
              const bf16* t = wait_step();
              // S^T = K Q^T, dP^T = V G^T
              products(j - 1, t + TILE, t, t + 2 * TILE, t + 3 * TILE, min(CW, d - c * CW));
              if (j == chunks) {  // the stage holds chunk oc
#pragma unroll
                for (int i = 0; i < kStreamWarps; ++i) {
                  uint32_t pa[4], da[4];
                  probs_t(pa, da, sacc[i], dacc[i], wd, WS, qp * kPanel + 16 * i, F, scale_log2,
                          lane);
                  tiles::tile_av<8>(acc_v, pa, t + 3 * TILE + (size_t)i * 16 * CWP, CWP, wo, lane);
                  tiles::tile_av<8>(acc_k, da, t + (size_t)i * 16 * CWP, CWP, wo, lane);
                }
              }
              free_step();
            }
          if (k0 < F) {
            store_grad(staging, staged, &dv_map, acc_v, CW, 1.f, oc * CW, h, l, k0, b, lane);
            store_grad(staging, staged, &dk_map, acc_k, CW, scale, oc * CW, h, l, k0, b, lane);
          }
        }
      }
      // C. dQ of the query tiles, a chunk a pass
      for (int qp = 0; qp < NP; ++qp) {
        const int q0 = qp * kPanel + 16 * warp;
        float m[2], inv[2], delta[2];
        get_words(m, inv, delta, wd, WS, q0, lane);
        for (int oc = 0; oc < chunks; ++oc) {
          const int wo = min(CW, d - oc * CW);
          float acc_q[8][4];
          tiles::zero(acc_q);
          for (int kp = 0; kp < NP; ++kp)
            for (int j = 1; j <= chunks; ++j) {
              const int c = (oc + j) % chunks;
              const bf16* t = wait_step();
              products(j - 1, t, t + TILE, t + 3 * TILE, t + 2 * TILE, min(CW, d - c * CW));
              if (j == chunks) {  // the stage holds chunk oc
#pragma unroll
                for (int i = 0; i < kStreamWarps; ++i) {
                  uint32_t da[4];
                  dscores(da, sacc[i], dacc[i], m, inv, delta, kp * kPanel + 16 * i, F,
                          scale_log2, lane);
                  tiles::tile_av<8>(acc_q, da, t + TILE + (size_t)i * 16 * CWP, CWP, wo, lane);
                }
              }
              free_step();
            }
          if (q0 < F)
            store_grad(staging, staged, &dq_map, acc_q, CW, scale, oc * CW, h, l, q0, b, lane);
        }
      }
    }
  }
  if (lane == 0) bulk_wait<0, false>();
}

template <bool STREAMED, bool PANELS, int KS>
int launch_long(const void* q, const void* k, const void* v, const void* g, void* dq, void* dk,
                void* dv, int B, int F, int L, int heads, int d, int per, int CW, int CWP,
                int chunks, int stages, int smem, int scale_d, cudaStream_t stream) {
  const int C = heads * d;
  const int FP = (F + 15) / 16 * 16, NP = (F + kPanel - 1) / kPanel;
  const int rows = STREAMED ? kPanel : FP;
  const int ow = STREAMED ? CW : min(kSlab, d);
  const int words = STREAMED ? 2 * 3 * NP * kPanel : stages * per * (PANELS ? 6 : 3) * FP;
  const int pds = PANELS ? 2 * FP * kPanelLd : 0;
  CUtensorMap maps[7];
  int err = make_map_4d(&maps[0], q, C, L, F, B, CWP, 1, rows);
  if (!err) err = make_map_4d(&maps[1], k, C, L, F, B, CWP, 1, rows);
  if (!err) err = make_map_4d(&maps[2], v, C, L, F, B, CWP, 1, rows);
  if (!err) err = make_map_4d(&maps[3], g, C, L, F, B, CWP, 1, rows);
  if (!err) err = make_frames_head_map(&maps[4], dq, d, heads, L, F, B, ow, 16);
  if (!err) err = make_frames_head_map(&maps[5], dk, d, heads, L, F, B, ow, 16);
  if (!err) err = make_frames_head_map(&maps[6], dv, d, heads, L, F, B, ow, 16);
  if (err) return err;
  const int bytes = (int)long_bwd_smem(rows, CWP, ow, stages, words, pds);
  if (bytes != smem || bytes > 232448) return (int)cudaErrorInvalidValue;
  auto kernel = temporal_bwd_long_kernel<STREAMED, PANELS, KS>;
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
  const float scale = 1.f / sqrtf((float)scale_d);
  kernel<<<grid, kLongThreads, bytes, stream>>>(maps[0], maps[1], maps[2], maps[3], maps[4],
                                                maps[5], maps[6], B, F, L, heads, d, per, CW,
                                                CWP, chunks, stages, scale * kLog2e, scale);
  return (int)cudaGetLastError();
}

// ---- more than 32 frames: the frames kernel --------------------------------
//
// This kernel takes the item design of the f <= 32 kernels past 32 frames,
// up to kFramesTiles 16-frame tiles (128 frames; past that the plan takes
// the long kernel above). An item is one position x all f frames x a chunk of
// whole heads (`long_backward_plan` in ops/temporal_attention.py: the most
// heads whose stages leave one spare beside the consumer groups'), loaded
// by one TMA box a tensor from the 4-D maps (c, l, f, b) into a ring of
// `stages` stages (a producer warp, mbarriers with transaction counts, a
// persistent grid). A head wider than the plan's chunk is an item of its
// own, walked in `chunks` column chunks twice, as the wide kernel does at
// f <= 32: the first pass loads Q, K, V and G of each chunk and sums S and
// dP over the chunks (in kPiece-column partials, added in fp32), the
// second loads Q, K and G again and writes the chunk's gradients.
// A group of QT = ceil(f / 16) consumer warps works on one head at a time,
// warp w of the group on query tile w and, for the transposed products,
// key tile w:
//   1. S and dP of its query rows (16 x 16 QT each, in registers, by
//      `mma.sync.m16n8k16` from the stage), the softmax in the log2 domain,
//      delta, P and dS = P (dP - delta), both rounded to bf16 as the plain
//      version rounds them and written to shared memory (P and dS, [16 QT]
//      x [16 QT + 8] each: 9 KB at 48 frames, 69.6 KB the pair at 128);
//   2. dV of its key rows = P^T G (A by ldmatrix.trans from P), over V;
//   3. dQ of its query rows = dS K * scale, over G;
//   4. dK of its key rows = dS^T Q * scale, over K;
// with a named barrier of the group's warps after the P and dS writes (the
// inputs' reads and P and dS whole), and, as each step writes over an input
// the step before read in every row, between 2, 3 and 4 and before the
// next head's P and dS writes. Up to 64 columns a warp holds dQ and dK in
// registers until one barrier says K and G are read, then writes both: two
// barriers a head. S and dP are computed once. Up to 48 frames a block
// holds three groups (`frames_groups`, P and dS each), which take the
// block's items in turn: a group's chain of products, softmax and barriers
// is latency-bound (on the H100 one group ran level 0 at 31% of its byte
// bound, two 54%, three 62%, with 80-column items that leave a stage
// spare). Every
// warp waits for every stage and frees it, the other groups' too, so that
// no warp can be lapped by the ring. The gradients leave as in the f <= 32
// kernels: the producer warp's lane 0 stores each by one bulk copy a frame
// row once the stage is freed (144 copies an item at 48 frames; the loop
// must stay free of integer divisions, which doubled the kernel's time,
// and 32 lanes issuing them were slower than one), then loads the stage
// again. Rows past f, and columns past a head's (or a chunk's, or a
// partial's) last in the last 16-deep step, are removed by selects, never
// by a multiply, as there. No atomics: the same inputs give the same bits.
// Registers: at 7-8 tiles (97-128 frames) S and dP of a warp's query rows
// are 8 QT = 56-64 fp32 a thread each, held whole beside the products'
// fragments, in one group of QT + 1 warps (up to 224 registers a thread);
// a wide item's chunk partials are summed one 16-key tile at a time, so
// they add 16 fp32, not 16 QT.
constexpr int kFramesTiles = 8;  // 16-frame tiles of the frames kernel: 128 frames

// Consumer groups of a block at QT 16-frame tiles: three up to 48 frames.
__host__ __device__ constexpr int frames_groups(int QT) { return QT <= 3 ? 3 : 1; }
// Blocks an SM the registers are budgeted for.
constexpr int kFramesBlocks = 1;
// Lanes of the producer warp that issue a stage's gradient copies.
constexpr int kStoreLanes = 1;
// The widest head whose dQ and dK a warp holds in registers (one 64-column
// piece each) until the group has read K and G: two barriers a head, not
// four.
constexpr int kFramesHeld = 64;

// Store the gradients a stage holds for the item `w` (columns col ..
// col + width): dQ from the G tile, dK from the K tile, dV from the V
// tile, one bulk copy a frame row, rows r0, r0 + n, .. of each by this
// thread; then commit them as one bulk group.
__device__ __forceinline__ void frames_store(const Item& w, const bf16* t, int TILE, int CWP,
                                             bf16* dq, bf16* dk, bf16* dv, int F, int L, int C,
                                             int col, int width, int r0, int n) {
  const bf16* src[3] = {t + 3 * TILE, t + TILE, t + 2 * TILE};
  bf16* dst[3] = {dq, dk, dv};
  const size_t step = (size_t)n * L * C;  // n frame rows of a gradient
#pragma unroll
  for (int g = 0; g < 3; ++g) {
    bf16* out = dst[g] + (((size_t)w.b * F + r0) * L + w.pos) * C + col;
    const bf16* in = src[g] + (size_t)r0 * CWP;
    for (int r = r0; r < F; r += n, out += step, in += (size_t)n * CWP)
      bulk_store(out, in, (uint32_t)width * 2);
  }
  bulk_commit();
}

__host__ __device__ inline int frames_room_elems(int F, int cwp) {
  return ((((F + 15) / 16) * 16 - F) * cwp + 63) / 64 * 64;
}

// The stages' Q, K, V and G tiles ([F][cwp] each), the room past the last
// for the mma tiles' rows past F, each group's P and dS, the barriers.
// `long_backward_smem` in ops/temporal_attention.py reckons the same.
__host__ __device__ inline size_t frames_smem_bytes(int F, int cwp, int stages) {
  const int FP = (F + 15) / 16 * 16;
  return 128 + ((size_t)stages * 4 * tile_elems(F, cwp) + (size_t)frames_room_elems(F, cwp) +
                (size_t)frames_groups(FP / 16) * 2 * FP * (FP + 8)) * 2 + 2 * stages * 8;
}

// s += Q K^T and dp += G V^T for rows 16 r.. of Q and G against all 16 QT
// rows of K and V (s[j] is key rows 8j..), over `width` columns from the
// tiles (rows LD apart), both products in one loop; the columns past width
// in the last 16-deep step are zeroed in every operand.
template <int QT>
__device__ __forceinline__ void frames_rows(float (&s)[2 * QT][4], float (&dp)[2 * QT][4],
                                            const bf16* sq, const bf16* sk, const bf16* sg,
                                            const bf16* sv, int LD, int r, int width,
                                            int lane) {
  const int arow = (16 * r + lane % 16) * LD + (lane / 16) * 8;
  const int brow = ((lane % 8) + (lane / 16) * 8) * LD + ((lane / 8) % 2) * 8;
  for (int kk = 0; 16 * kk < width; ++kk) {
    const bool tail = 16 * kk + 8 >= width;
    uint32_t aq[4], ag[4];
    ldmatrix_x4(aq, sq + arow + kk * 16);
    ldmatrix_x4(ag, sg + arow + kk * 16);
    if (tail) aq[2] = aq[3] = ag[2] = ag[3] = 0u;
#pragma unroll
    for (int jp = 0; jp < QT; ++jp) {
      uint32_t bk[4], bv[4];
      ldmatrix_x4(bk, sk + jp * 16 * LD + brow + kk * 16);
      ldmatrix_x4(bv, sv + jp * 16 * LD + brow + kk * 16);
      if (tail) bk[1] = bk[3] = bv[1] = bv[3] = 0u;
      mma_bf16(s[2 * jp], aq, bk[0], bk[1]);
      mma_bf16(s[2 * jp + 1], aq, bk[2], bk[3]);
      mma_bf16(dp[2 * jp], ag, bv[0], bv[1]);
      mma_bf16(dp[2 * jp + 1], ag, bv[2], bv[3]);
    }
  }
}

template <int QT>
__device__ __forceinline__ void frames_zero(float (&acc)[2 * QT][4]) {
#pragma unroll
  for (int j = 0; j < 2 * QT; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;
}

// s and dp += the products over `width` columns in kPiece-column partials
// (each summed from zero by the tensor cores, then added in fp32: the wide
// kernel's bound on the accumulation's error at d = 1280), one 16-key tile
// of partials at a time (the same sums in the same order as all at once).
template <int QT>
__device__ __forceinline__ void frames_rows_pieces(float (&s)[2 * QT][4],
                                                   float (&dp)[2 * QT][4], const bf16* sq,
                                                   const bf16* sk, const bf16* sg,
                                                   const bf16* sv, int LD, int r, int width,
                                                   int lane) {
  for (int off = 0; off < width; off += kPiece) {
#pragma unroll
    for (int jp = 0; jp < QT; ++jp) {
      float ps[2][4], pdp[2][4];
      frames_zero<1>(ps);
      frames_zero<1>(pdp);
      frames_rows<1>(ps, pdp, sq + off, sk + jp * 16 * LD + off, sg + off,
                     sv + jp * 16 * LD + off, LD, r, min(kPiece, width - off), lane);
#pragma unroll
      for (int j = 0; j < 2; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          s[2 * jp + j][e] += ps[j][e];
          dp[2 * jp + j][e] += pdp[j][e];
        }
    }
  }
}

// From S and dP of query tile r (s, dp: element e of tile j is key 8j +
// 2 (lane % 4) + (e & 1) of query 16 r + lane / 4 + 8 (e >> 1)): P and dS,
// zero at query or key frames >= F, rounded to bf16 into rows 16 r.. of sp
// and sd ([FP][FP + 8]). The selects run only on the 8-key tiles and the
// 16-row tile that reach frame F (none at f = 48 and 64): at d = 40 the
// softmax is most of a head's instructions.
template <int QT>
__device__ __forceinline__ void frames_softmax(float (&s)[2 * QT][4], float (&dp)[2 * QT][4],
                                               bf16* sp, bf16* sd, int F, int r,
                                               float scale_log2, int lane) {
  constexpr int LDP = 16 * QT + 8;
  const int c2 = 2 * (lane % 4);
  float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
  for (int j = 0; j < 2 * QT; ++j) {
    if (8 * j + 8 > F) {  // keys >= F: no logit, no dP
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const bool key_ok = 8 * j + c2 + (e & 1) < F;
        s[j][e] = key_ok ? s[j][e] * scale_log2 : -INFINITY;
        dp[j][e] = key_ok ? dp[j][e] : 0.f;
      }
    } else {
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] *= scale_log2;
    }
#pragma unroll
    for (int e = 0; e < 4; ++e) mx[e >> 1] = fmaxf(mx[e >> 1], s[j][e]);
  }
  float sum[2] = {0.f, 0.f}, delta[2] = {0.f, 0.f};
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
    mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
  }
#pragma unroll
  for (int j = 0; j < 2 * QT; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      s[j][e] = exp2f(s[j][e] - mx[e >> 1]);
      sum[e >> 1] += s[j][e];
    }
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    sum[i] += __shfl_xor_sync(0xffffffffu, sum[i], 1);
    sum[i] += __shfl_xor_sync(0xffffffffu, sum[i], 2);
    sum[i] = 1.f / sum[i];
  }
#pragma unroll
  for (int j = 0; j < 2 * QT; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      s[j][e] *= sum[e >> 1];
      delta[e >> 1] += s[j][e] * dp[j][e];
    }
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    delta[i] += __shfl_xor_sync(0xffffffffu, delta[i], 1);
    delta[i] += __shfl_xor_sync(0xffffffffu, delta[i], 2);
  }
  const int row = 16 * r + lane / 4;
  const bool rows_ok = 16 * r + 16 <= F;  // no query >= F in this tile
#pragma unroll
  for (int j = 0; j < 2 * QT; ++j) {
    float pv[4], dv[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) dv[e] = s[j][e] * (dp[j][e] - delta[e >> 1]);
    if (!rows_ok || 8 * j + 8 > F) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const bool valid = 8 * j + c2 + (e & 1) < F && row + 8 * (e >> 1) < F;
        dv[e] = valid ? dv[e] : 0.f;
        pv[e] = valid ? s[j][e] : 0.f;
      }
    } else {
#pragma unroll
      for (int e = 0; e < 4; ++e) pv[e] = s[j][e];
    }
    *reinterpret_cast<uint32_t*>(sp + row * LDP + 8 * j + c2) = pack_bf16(pv[0], pv[1]);
    *reinterpret_cast<uint32_t*>(sp + (row + 8) * LDP + 8 * j + c2) = pack_bf16(pv[2], pv[3]);
    *reinterpret_cast<uint32_t*>(sd + row * LDP + 8 * j + c2) = pack_bf16(dv[0], dv[1]);
    *reinterpret_cast<uint32_t*>(sd + (row + 8) * LDP + 8 * j + c2) = pack_bf16(dv[2], dv[3]);
  }
}

// The A fragments of rows 16 r.. of X, the 16 QT-square bf16 matrix at sx
// ([FP][FP + 8]): its rows r (TRANS false) or its columns r (TRANS true:
// X^T's rows, by ldmatrix.trans), a[t] contracting frames 16 t.. .
template <int QT, bool TRANS>
__device__ __forceinline__ void frames_a(uint32_t (&a)[QT][4], const bf16* sx, int r,
                                         int lane) {
  constexpr int LDP = 16 * QT + 8;
#pragma unroll
  for (int t = 0; t < QT; ++t) {
    if constexpr (TRANS)
      ldmatrix_x4_trans(a[t], sx + (16 * t + 8 * (lane / 16) + lane % 8) * LDP + 16 * r +
                                  8 * ((lane / 8) % 2));
    else
      ldmatrix_x4(a[t], sx + (16 * r + lane % 16) * LDP + 16 * t + (lane / 16) * 8);
  }
}

// o = A B over the columns n0 .. n0 + min(64, width - n0) of B, from sb
// (frames LDB apart; rows >= F zeroed in the fragments); o[n] is columns
// n0 + 8 n.. .
template <int QT>
__device__ __forceinline__ void frames_piece(float (&o)[8][4], const uint32_t (&a)[QT][4],
                                             const bf16* sb, int LDB, int n0, int F, int width,
                                             int lane) {
#pragma unroll
  for (int n = 0; n < 8; ++n) o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0.f;
#pragma unroll
  for (int t = 0; t < QT; ++t) {
#pragma unroll
    for (int np = 0; np < 4; ++np) {
      if (n0 + 16 * np >= width) break;
      uint32_t b[4];
      ldmatrix_x4_trans(b, sb + (t * 16 + (lane % 8) + ((lane / 8) % 2) * 8) * LDB + n0 +
                               np * 16 + (lane / 16) * 8);
      if (16 * t + 16 > F) {  // only the last tile holds frames >= F
        // registers 0 and 2 hold frames t*16 + 2*(lane%4) (+1), 1 and 3 eight later
        const int fr = t * 16 + 2 * (lane % 4);
        b[0] = mask_frames(b[0], fr, F);
        b[2] = mask_frames(b[2], fr, F);
        b[1] = mask_frames(b[1], fr + 8, F);
        b[3] = mask_frames(b[3], fr + 8, F);
      }
      mma_bf16(o[2 * np], a[t], b[0], b[1]);
      mma_bf16(o[2 * np + 1], a[t], b[2], b[3]);
    }
  }
}

// o times `mul` as bf16 to rows 16 r.. (< F) of dst (LDO apart), columns
// n0 .. n0 + min(64, width - n0).
__device__ __forceinline__ void frames_piece_store(const float (&o)[8][4], bf16* dst, int LDO,
                                                   int r, int n0, int F, int width, float mul,
                                                   int lane) {
  const int row = 16 * r + lane / 4;
#pragma unroll
  for (int n = 0; n < 8; ++n) {
    if (n0 + 8 * n >= width) break;
    const int col = n0 + 8 * n + 2 * (lane % 4);
    if (row < F)
      *reinterpret_cast<__nv_bfloat162*>(dst + row * LDO + col) =
          __floats2bfloat162_rn(o[n][0] * mul, o[n][1] * mul);
    if (row + 8 < F)
      *reinterpret_cast<__nv_bfloat162*>(dst + (row + 8) * LDO + col) =
          __floats2bfloat162_rn(o[n][2] * mul, o[n][3] * mul);
  }
}

// Rows 16 r.. of X B times `mul` over `width` columns (frames_a,
// frames_piece), stored as bf16 to dst's rows < F, in pieces of 64 columns.
template <int QT, bool TRANS>
__device__ __forceinline__ void frames_grad(const bf16* sx, const bf16* sb, int LDB, bf16* dst,
                                            int LDO, int r, int F, int width, float mul,
                                            int lane) {
  uint32_t a[QT][4];
  frames_a<QT, TRANS>(a, sx, r, lane);
  for (int n0 = 0; n0 < width; n0 += 64) {
    float o[8][4];
    frames_piece<QT>(o, a, sb, LDB, n0, F, width, lane);
    frames_piece_store(o, dst, LDO, r, n0, F, width, mul, lane);
  }
}

// grid: persistent, at most one block per item; block 32 (G QT + 1).
template <int QT>
__global__ void __launch_bounds__(32 * (frames_groups(QT) * QT + 1), kFramesBlocks)
temporal_bwd_frames_kernel(const __grid_constant__ CUtensorMap q_map,
                           const __grid_constant__ CUtensorMap k_map,
                           const __grid_constant__ CUtensorMap v_map,
                           const __grid_constant__ CUtensorMap g_map, bf16* __restrict__ dq,
                           bf16* __restrict__ dk, bf16* __restrict__ dv, int B, int F, int L,
                           int C, int d, int CW, int CWP, int chunks, int stages,
                           float scale_log2, float scale) {
  constexpr int G = frames_groups(QT), FP = 16 * QT, LDP = FP + 8;
  constexpr int NT = 32 * QT;  // the threads of a consumer group
  extern __shared__ unsigned char smem_raw[];
  bf16* tiles = reinterpret_cast<bf16*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 127) & ~static_cast<uintptr_t>(127));
  const int TILE = tile_elems(F, CWP), STAGE = 4 * TILE;  // Q, K, V, G
  bf16* pds = tiles + (size_t)stages * STAGE + frames_room_elems(F, CWP);
  uint64_t* full = reinterpret_cast<uint64_t*>(pds + (size_t)G * 2 * FP * LDP);
  uint64_t* empty = full + stages;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const bool wide = chunks > 1;  // one head an item, in chunks, two passes
  const int per = wide ? 1 : CW / d;           // heads of an item
  const int per_pos = wide ? C / d : C / CW;   // items of a position
  const int items = B * L * per_pos;
  const int steps = wide ? 2 * chunks : 1;     // stages an item takes

  if (threadIdx.x == 0) {
    for (int s = 0; s < stages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], G * QT);
    }
    fence_barrier_init();
  }
  __syncthreads();

  // the gradients of step m leave its stage (a first-pass step of a wide
  // item has none), by `n` threads of which this is thread i0
  auto store = [&](int m, int i0, int n) {
    const int j = m % steps;
    if (wide && j < chunks) return;
    const Item w = item_of(blockIdx.x + (m / steps) * gridDim.x, per_pos, L);
    frames_store(w, tiles + (size_t)(m % stages) * STAGE, TILE, CWP, dq, dk, dv, F, L, C,
                 wide ? w.chunk * d + (j - chunks) * CW : w.chunk * CW,
                 wide ? min(CW, d - (j - chunks) * CW) : CW, i0, n);
  };

  if (warp == G * QT) {
    // producer warp: once a stage is free, kStoreLanes lanes store its
    // gradients, each a share of the rows, and lane 0 loads it again after
    // every copy has read it (each lane waits for its own copies' reads,
    // then the warp meets, so that no lane spins on the next stage while
    // lane 0 loads)
    int n = 0;
    for (int it = blockIdx.x; it < items; it += gridDim.x) {
      const Item w = item_of(it, per_pos, L);
      for (int j = 0; j < steps; ++j, ++n) {
        const int s = n % stages;
        bf16* t = tiles + (size_t)s * STAGE;
        if (n >= stages) {
          mbar_wait(&empty[s], ((n / stages) - 1) & 1);
          if (lane < kStoreLanes) {
            store(n - stages, lane, kStoreLanes);
            bulk_wait<0, true>();  // the stores have read the stage the loads below write
          }
          __syncwarp();
        }
        if (lane == 0) {
          const bool first = !wide || j < chunks;  // V is loaded in the first pass only
          const int col = wide ? w.chunk * d + (j % chunks) * CW : w.chunk * CW;
          mbar_arrive_expect_tx(&full[s], (first ? 4u : 3u) * F * CWP * 2);
          tma_load_4d(t, &q_map, &full[s], col, w.pos, 0, w.b);
          tma_load_4d(t + TILE, &k_map, &full[s], col, w.pos, 0, w.b);
          if (first) tma_load_4d(t + 2 * TILE, &v_map, &full[s], col, w.pos, 0, w.b);
          tma_load_4d(t + 3 * TILE, &g_map, &full[s], col, w.pos, 0, w.b);
        }
        __syncwarp();
      }
    }
    for (int m = n > stages ? n - stages : 0; m < n; ++m) {
      mbar_wait(&empty[m % stages], (m / stages) & 1);
      if (lane < kStoreLanes) store(m, lane, kStoreLanes);
    }
    bulk_wait<0, false>();
    return;
  }
  // a group's end of a step that holds gradients: its writes before the
  // bulk copies read them, then the stage freed
  auto leave = [&](int st) {
    fence_proxy_async();
    __syncwarp();
    if (lane == 0) mbar_arrive(&empty[st]);
  };

  // consumers: group `group` takes the block's items group, group + G, ..;
  // its warp `wq` owns query tile wq and key tile wq of every head; every
  // warp waits for every step and frees it
  const int group = warp / QT, wq = warp % QT, bar = 1 + group;
  bf16* sp = pds + (size_t)group * 2 * FP * LDP;
  bf16* sd = sp + FP * LDP;
  float s[2 * QT][4], dp[2 * QT][4];
  int n = 0, mine = 0;
  for (int it = blockIdx.x; it < items; it += gridDim.x, ++mine) {
    if (mine % G != group) {  // the other group's item: its stages pass by
      for (int j = 0; j < steps; ++j, ++n) {
        mbar_wait(&full[n % stages], (n / stages) & 1);
        __syncwarp();
        if (lane == 0) mbar_arrive(&empty[n % stages]);
      }
      continue;
    }
    if (!wide) {
      const int st = n % stages;
      mbar_wait(&full[st], (n / stages) & 1);
      bf16* tq = tiles + (size_t)st * STAGE;
      bf16 *tk = tq + TILE, *tv = tq + 2 * TILE, *tg = tq + 3 * TILE;
      for (int hh = 0; hh < per; ++hh) {
        const int off = hh * d;
        frames_zero<QT>(s);
        frames_zero<QT>(dp);
        frames_rows<QT>(s, dp, tq + off, tk + off, tg + off, tv + off, CWP, wq, d,
                        lane);  // S = Q K^T, dP = G V^T
        if (hh == 0 || d > kFramesHeld)
          named_bar_sync(bar, NT);  // every warp's reads of the last head's dS done
        frames_softmax<QT>(s, dp, sp, sd, F, wq, scale_log2, lane);
        named_bar_sync(bar, NT);  // P and dS whole; every read of V done
        frames_grad<QT, true>(sp, tg + off, CWP, tv + off, CWP, wq, F, d, 1.f, lane);
        if (d <= kFramesHeld) {
          // dQ and dK in registers until every warp has read G and K, then
          // over them: two barriers a head
          float oq[8][4], ok[8][4];
          uint32_t a[QT][4];
          frames_a<QT, false>(a, sd, wq, lane);
          frames_piece<QT>(oq, a, tk + off, CWP, 0, F, d, lane);
          frames_a<QT, true>(a, sd, wq, lane);
          frames_piece<QT>(ok, a, tq + off, CWP, 0, F, d, lane);
          named_bar_sync(bar, NT);  // every read of G, K, Q and dS done
          frames_piece_store(oq, tg + off, CWP, wq, 0, F, d, scale, lane);
          frames_piece_store(ok, tk + off, CWP, wq, 0, F, d, scale, lane);
          continue;
        }
        named_bar_sync(bar, NT);  // every read of G done
        frames_grad<QT, false>(sd, tk + off, CWP, tg + off, CWP, wq, F, d, scale, lane);
        named_bar_sync(bar, NT);  // every read of K done
        frames_grad<QT, true>(sd, tq + off, CWP, tk + off, CWP, wq, F, d, scale, lane);
      }
      leave(st);
      ++n;
      continue;
    }
    // a wide item: S and dP summed over the chunks, then the gradients
    frames_zero<QT>(s);
    frames_zero<QT>(dp);
    for (int c = 0; c < chunks; ++c, ++n) {
      const int st = n % stages;
      mbar_wait(&full[st], (n / stages) & 1);
      const bf16* tq = tiles + (size_t)st * STAGE;
      const int width = min(CW, d - c * CW);
      frames_rows_pieces<QT>(s, dp, tq, tq + TILE, tq + 3 * TILE, tq + 2 * TILE, CWP, wq,
                             width, lane);  // Q K^T, G V^T
      __syncwarp();
      if (lane == 0) mbar_arrive(&empty[st]);
    }
    named_bar_sync(bar, NT);  // every warp's dK of the last item has read dS
    frames_softmax<QT>(s, dp, sp, sd, F, wq, scale_log2, lane);
    named_bar_sync(bar, NT);
    for (int c = 0; c < chunks; ++c, ++n) {
      const int st = n % stages;
      mbar_wait(&full[st], (n / stages) & 1);
      bf16* tq = tiles + (size_t)st * STAGE;
      bf16 *tk = tq + TILE, *tv = tq + 2 * TILE, *tg = tq + 3 * TILE;
      const int width = min(CW, d - c * CW);
      // dV into the V tile (not loaded in this pass)
      frames_grad<QT, true>(sp, tg, CWP, tv, CWP, wq, F, width, 1.f, lane);
      named_bar_sync(bar, NT);  // every read of G done
      frames_grad<QT, false>(sd, tk, CWP, tg, CWP, wq, F, width, scale, lane);
      named_bar_sync(bar, NT);  // every read of K done
      frames_grad<QT, true>(sd, tq, CWP, tk, CWP, wq, F, width, scale, lane);
      leave(st);
    }
  }
}

template <int QT>
int launch_frames_kernel(const void* q, const void* k, const void* v, const void* g, void* dq,
                         void* dk, void* dv, int B, int F, int L, int heads, int d, int CW,
                         int CWP, int chunks, int stages, int smem, int scale_d,
                         cudaStream_t stream) {
  const int C = heads * d;
  CUtensorMap maps[4];
  int err = make_map_4d(&maps[0], q, C, L, F, B, CWP, 1, F);
  if (!err) err = make_map_4d(&maps[1], k, C, L, F, B, CWP, 1, F);
  if (!err) err = make_map_4d(&maps[2], v, C, L, F, B, CWP, 1, F);
  if (!err) err = make_map_4d(&maps[3], g, C, L, F, B, CWP, 1, F);
  if (err) return err;
  const int bytes = (int)frames_smem_bytes(F, CWP, stages);
  if (bytes != smem || bytes > 232448) return (int)cudaErrorInvalidValue;
  auto kernel = temporal_bwd_frames_kernel<QT>;
  constexpr int kThreadsF = 32 * (frames_groups(QT) * QT + 1);
  const void* fn = reinterpret_cast<const void*>(kernel);
  cudaError_t e = host_cache.reserve_smem(fn, bytes);
  if (e != cudaSuccess) return (int)e;
  int slots = 0;  // blocks the card holds at once: the persistent grid
  e = host_cache.get(fn, bytes, 0, &slots, [&](int* value) {
    int dev = 0, sms = 0, per_sm = 0;
    cudaError_t r = cudaGetDevice(&dev);
    if (r == cudaSuccess) r = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (r == cudaSuccess)
      r = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreadsF, bytes);
    *value = sms * per_sm;
    return r;
  });
  if (e != cudaSuccess) return (int)e;
  if (slots < 1) return (int)cudaErrorInvalidConfiguration;
  const long long items = (long long)B * L * (chunks > 1 ? heads : C / CW);
  const int grid = (int)(items < slots ? items : slots);
  const float scale = 1.f / sqrtf((float)scale_d);
  kernel<<<grid, kThreadsF, bytes, stream>>>(
      maps[0], maps[1], maps[2], maps[3], static_cast<bf16*>(dq), static_cast<bf16*>(dk),
      static_cast<bf16*>(dv), B, F, L, C, d, CW, CWP, chunks, stages, scale * kLog2e, scale);
  return (int)cudaGetLastError();
}

}  // namespace

// Head widths the kernel takes: d a multiple of 8, d <= 160 (the motion
// modules' d = 40/80/160, QK^T's depth padded to 48 / 80 / 160), as items of
// `heads_per_item` whole heads (CW = heads_per_item * d columns, chunks =
// 1); and 160 < d <= 1280, one head in `chunks` chunks (slices) of CW =
// ceil(d / chunks) rounded up to 8 columns. Either is loaded `cwp` columns
// wide (the wrapper's `temporal_plan`). The logits are scaled by
// scale_d^-1/2, 1 <= scale_d <= d (the true width of a head the wrapper
// zero-pads, else d). `mode` names the kernel: up to kMaxFrames frames
// kModeItems for whole heads (`stages` and `smem` not read), and for a head
// in slices the split kernel of the wrapper's `split_plan`,
// split::kModeSplit (the item kept for both sweeps, a ring of at least 4
// tensor slots) or split::kModeSplitStreamed (Q, K and G loaded again for
// the second sweep, at least 2), with `heads_per_item` positions an item,
// `stages` slots and `smem` bytes; past kMaxFrames kModeFrames,
// up to 16 kFramesTiles (128) frames, the frames kernel with the items of
// `long_backward_plan` (any d a multiple of 8 up to 1280, in chunks of at
// most 160 columns, whole heads or one head in chunks) in a ring of
// `stages` >= 2 stages; or the long kernel with the wrapper's
// `long_bwd_plan`, kModeResident (whole heads of d <= 160, f rounded up to
// 16 at most 256) or kModeStreamed (one head in `chunks` chunks of at most
// kLongChunk columns). `smem` is the bytes the plan reckons for its
// stages (the kernel checks them against its own).
extern "C" int hv_temporal_bwd(const void* q, const void* k, const void* v, const void* g,
                               void* dq, void* dk, void* dv, int B, int F, int L, int heads,
                               int d, int heads_per_item, int cwp, int chunks, int scale_d,
                               int mode, int stages, int smem, void* stream) {
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
  if (F > kMaxFrames && mode == kModeFrames) {
    if (F > 16 * kFramesTiles || stages < 2 || CW > kChunkColumns)
      return (int)cudaErrorInvalidValue;
#define FRAMES_KERNEL(QT)                                                                     \
  launch_frames_kernel<QT>(q, k, v, g, dq, dk, dv, B, F, L, heads, d, CW, cwp, chunks, stages, \
                           smem, scale_d, s)
    switch ((F + 15) / 16) {
      case 3: return FRAMES_KERNEL(3);
      case 4: return FRAMES_KERNEL(4);
      case 5: return FRAMES_KERNEL(5);
      case 6: return FRAMES_KERNEL(6);
      case 7: return FRAMES_KERNEL(7);
      default: return FRAMES_KERNEL(8);
    }
#undef FRAMES_KERNEL
  }
  if (F > kMaxFrames) {
    if (stages < 1 || stages > kLongMaxStages) return (int)cudaErrorInvalidValue;
    if (mode == kModeResident) {
      if (chunks != 1 || CW > kChunkColumns || (F + 15) / 16 * 16 > 256)
        return (int)cudaErrorInvalidValue;
#define RESIDENT(PANELS, KS)                                                               \
  launch_long<false, PANELS, KS>(q, k, v, g, dq, dk, dv, B, F, L, heads, d, heads_per_item, CW, \
                                 cwp, chunks, stages, smem, scale_d, s)
      // the head's 16-deep steps: up to 4 with the key panels, else 4, 6,
      // 8 or 10 (one more step where that many would be odd)
      const int steps = (d + 15) / 16;
      if (d <= kPanelWidth && (F + 15) / 16 <= kHeldTiles * kLongConsumers) {
        switch (steps) {
          case 1: return RESIDENT(true, 1);
          case 2: return RESIDENT(true, 2);
          case 3: return RESIDENT(true, 3);
          default: return RESIDENT(true, 4);
        }
      }
      if (steps <= 4) return RESIDENT(false, 4);
      if (steps <= 6) return RESIDENT(false, 6);
      if (steps <= 8) return RESIDENT(false, 8);
      return RESIDENT(false, 10);
#undef RESIDENT
    }
    if (mode != kModeStreamed || heads_per_item != 1 || CW > kLongChunk)
      return (int)cudaErrorInvalidValue;
    return launch_long<true, false, 0>(q, k, v, g, dq, dk, dv, B, F, L, heads, d, 1, CW, cwp,
                                       chunks, stages, smem, scale_d, s);
  }
  if (sliced) {
    const bool streamed = mode == split::kModeSplitStreamed;
    if ((mode != split::kModeSplit && !streamed) || d <= kChunkColumns ||
        !split::plan_ok(F, d, chunks, heads_per_item, CW, cwp, stages, streamed ? 2 : 4, smem))
      return (int)cudaErrorInvalidValue;
#define SPLIT(MT, STREAMED)                                                                  \
  launch_split<MT, STREAMED>(q, k, v, g, dq, dk, dv, B, F, L, heads, d, CW, cwp, chunks,       \
                             heads_per_item, stages, smem, scale_d, s)
    if (F <= 16) return streamed ? SPLIT(1, true) : SPLIT(1, false);
    return streamed ? SPLIT(2, true) : SPLIT(2, false);
#undef SPLIT
  }
  if (mode != kModeItems) return (int)cudaErrorInvalidValue;
#define FRAMES(DP) \
  launch_frames<DP>(q, k, v, g, dq, dk, dv, B, F, L, heads, d, CW, cwp, scale_d, s)
  if (d <= 48) return FRAMES(48);
  if (d <= 80) return FRAMES(80);
  if (d <= 160) return FRAMES(160);
#undef FRAMES
  return (int)cudaErrorInvalidValue;
}

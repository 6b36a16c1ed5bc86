// Kernel B's heads wider than 160 columns (up to 1280) at f <= 32 frames:
// the pieces shared by the forward's and the backward's split kernels
// (`temporal_fwd_split_kernel`, csrc/temporal_attention.cu;
// `temporal_bwd_split_kernel`, csrc/temporal_attention_bwd.cu).
//
// A head is split into `slices` column slices of CW columns (a multiple of
// 8, at most 160; the last d - (slices - 1) * CW), one consumer warp a
// slice: an item is `positions` positions x all F frames x one head, and
// warp w takes slice w % slices of position w / slices (positions x slices
// <= kWarps warps work, the rest leave). Each warp's Q, K, V (and G) of its
// slice are its own [F][CWP] tile in a ring slot, one TMA box each from a
// 4-D map (d, heads * L, F, B): the box's CWP - CW columns past the slice
// are the next slice's (removed from the products by a select) or, past
// the head's last column, zeros, so no box reads another head. A warp sums
// its slice's part of S = Q K^T (and dP = G V^T) over 64-column pieces in
// fp32, the warps of a position add the parts through shared memory in
// slice order (the same bits in each, whatever the timing), and each then
// takes the softmax and its own slice of the outputs. The outputs are
// written over the tile they are computed from, in place, and leave by one
// 5-D TMA store a (warp, output) from a map whose innermost dimension is
// one slice's columns (CW, or the last slice's width), so the padded
// tile's columns past the slice are not written.
//
// The ring's unit is one tensor of an item (every working warp's tile of
// Q, K, V or G): a slot is freed as soon as no warp needs it (Q and K
// after S), so the next item's loads run under this item's products and
// stores. A block is kWarps consumer warps and a producer warp whose lane
// 0 issues the loads. The forward's O is stored by a store warp, whose
// lane 0 issues an output's stores once every consumer has written its
// tile (a `ready` barrier), waits for them to read the slot and frees it,
// so that no consumer waits for a store; the backward's gradients are
// stored by each consumer, which frees a slot once its store has read it.
#pragma once

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include "hopper.cuh"
#include "warp_mma.cuh"

namespace split {

constexpr int kWarps = 8;        // consumer warps (SPLIT_WARPS)
constexpr int kMaxStages = 8;    // the deepest ring of tensor slots (SPLIT_MAX_STAGES)
// The forward's outputs written and not yet stored at once (its store
// warp's `ready` barriers): at most one a slot.
constexpr int kReady = 16;
constexpr int kMaxSlice = 160;   // the widest slice (CHUNK_COLUMNS)
constexpr int kPiece = 64;       // columns of one partial sum of S and dP
// The entry points' modes of the split kernels (MODE_SPLIT,
// MODE_SPLIT_STREAMED): the backward's item kept in shared memory for
// the second sweep, or Q, K and G read again for it.
constexpr int kModeSplit = 4, kModeSplitStreamed = 5;

// Elements of one warp's tile ([F][cwp]), rounded to 128 bytes (TMA's
// alignment).
__host__ __device__ inline int tile_elems(int F, int cwp) { return (F * cwp + 63) / 64 * 64; }

// Floats of one warp's partial S (or dP) in the exchange: its fragments,
// 16 MT x 16 MT.
__host__ __device__ constexpr int exchange_floats(int MT) { return 256 * MT * MT; }

// Bytes past the exchange that the mma tiles' rows past F of the last
// slot's last tile read (16 MT rows from its start), where the exchange does
// not cover them.
__host__ __device__ inline int room_bytes(int F, int cwp, int warps) {
  const int MT = F <= 16 ? 1 : 2;
  const int over = (16 * MT - F) * cwp * 2 - warps * exchange_floats(MT) * 4;
  return over > 0 ? (over + 15) / 16 * 16 : 0;
}

// Bytes of shared memory a split kernel lays out for `warps` working warps:
// 128 bytes of alignment, `stages` slots of one tile a warp, the exchange
// (one partial a warp), the room past it, two barriers a slot and kReady
// `ready` barriers (unused in the backward, which has no store warp).
// `split_smem` in ops/temporal_attention.py reckons the same.
__host__ __device__ inline size_t smem_bytes(int F, int cwp, int stages, int warps) {
  const int MT = F <= 16 ? 1 : 2;
  return 128 + (size_t)stages * warps * tile_elems(F, cwp) * 2 +
         (size_t)warps * exchange_floats(MT) * 4 + room_bytes(F, cwp, warps) +
         (size_t)stages * 16 + kReady * 8;
}

// The pieces of a split kernel's shared memory.
struct Layout {
  bf16* tiles;      // slot s, warp w: tiles + (s * warps + w) * tile_elems(F, cwp)
  float* xbuf;      // the exchange
  uint64_t* full;   // [stages]: a slot's loads have landed
  uint64_t* empty;  // [stages]: every warp is done with a slot (or its output is stored)
  uint64_t* ready;  // [kReady]: the forward's output k written by every warp (ready[k % kReady])
};

template <int MT>
__device__ __forceinline__ Layout layout(unsigned char* raw, int F, int cwp, int stages,
                                         int warps) {
  Layout m;
  m.tiles = reinterpret_cast<bf16*>((reinterpret_cast<uintptr_t>(raw) + 127) &
                                    ~static_cast<uintptr_t>(127));
  m.xbuf = reinterpret_cast<float*>(m.tiles + (size_t)stages * warps * tile_elems(F, cwp));
  m.full = reinterpret_cast<uint64_t*>(reinterpret_cast<unsigned char*>(m.xbuf) +
                                       (size_t)warps * exchange_floats(MT) * 4 +
                                       room_bytes(F, cwp, warps));
  m.empty = m.full + stages;
  m.ready = m.empty + stages;
  return m;
}

// Arrive `count` times on the barrier.
__device__ __forceinline__ void mbar_arrive_count(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0], %1;\n" ::"r"(hopper::smem_u32(bar)),
               "r"(count)
               : "memory");
}

// The store warp's part for one output (lane 0): once every working warp
// has written its tile of slot `s` (output k, ready[k % kReady]), one 5-D
// TMA store a warp (`map` for slices 0 .. slices-2, `last` for the last; a
// position past L stores nothing), then, once they have read the slot, the
// slot freed for the producer.
__device__ __forceinline__ void store_output(const Layout& m, int k, int s, int TILE, int warps,
                                             int slices, const CUtensorMap* map,
                                             const CUtensorMap* last, int l0, int L, int heads,
                                             int h, int b) {
  hopper::mbar_wait(&m.ready[k % kReady], (k / kReady) & 1);
  const bf16* slot = m.tiles + (size_t)s * warps * TILE;
  for (int w = 0; w < warps; ++w) {
    const int l = l0 + w / slices, sl = w % slices;
    if (l < L)
      hopper::tma_store_5d(sl == slices - 1 ? last : map, slot + (size_t)w * TILE, 0,
                           sl == slices - 1 ? 0 : sl, l * heads + h, 0, b);
  }
  hopper::bulk_commit();
  hopper::bulk_wait<0, true>();
  mbar_arrive_count(&m.empty[s], warps);
}

// Zero the halves of a bf16 pair that hold frames >= F.
__device__ __forceinline__ uint32_t mask_frames(uint32_t v, int frame, int F) {
  return v & ((frame < F ? 0x0000ffffu : 0u) | (frame + 1 < F ? 0xffff0000u : 0u));
}

template <int MT>
__device__ __forceinline__ void zero(float (&acc)[MT][2 * MT][4]) {
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int j = 0; j < 2 * MT; ++j)
      acc[mt][j][0] = acc[mt][j][1] = acc[mt][j][2] = acc[mt][j][3] = 0.f;
}

// acc = A B^T over w columns (a multiple of 8) for A and B of 16 MT frames
// (rows ld apart): acc[mt][j] is rows 16mt.., columns 8j.. . The sums over
// each kPiece columns start from zero and are added in fp32 (the tensor
// cores' accumulation, not rounded to nearest, then spans at most 4
// 16-deep steps); in the last 16-deep step both operands' columns past w
// are removed by a select.
template <int MT>
__device__ __forceinline__ void partial_abt(float (&acc)[MT][2 * MT][4], const bf16* sa,
                                            const bf16* sb, int ld, int w, int lane) {
  zero<MT>(acc);
  for (int off = 0; off < w; off += kPiece) {
    float pc[MT][2 * MT][4];
    zero<MT>(pc);
#pragma unroll
    for (int kk = 0; kk < kPiece / 16; ++kk) {
      const int col = off + 16 * kk;
      if (col >= w) break;
      const bool tail = col + 8 >= w;
      uint32_t a[MT][4];
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        ldmatrix_x4(a[mt], sa + (mt * 16 + lane % 16) * ld + col + (lane / 16) * 8);
        if (tail) a[mt][2] = a[mt][3] = 0u;
      }
#pragma unroll
      for (int jp = 0; jp < MT; ++jp) {
        uint32_t b[4];
        ldmatrix_x4(b, sb + (jp * 16 + (lane % 8) + (lane / 16) * 8) * ld + col +
                           ((lane / 8) % 2) * 8);
        if (tail) b[1] = b[3] = 0u;
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) {
          mma_bf16(pc[mt][2 * jp], a[mt], b[0], b[1]);
          mma_bf16(pc[mt][2 * jp + 1], a[mt], b[2], b[3]);
        }
      }
    }
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int j = 0; j < 2 * MT; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[mt][j][e] += pc[mt][j][e];
  }
}

// The sum of the n warps' parts acc (warps first .. first + n - 1, this one
// among them) through the exchange xbuf, added in warp order from zero, so
// every warp of the position holds the same bits. Named barrier `bar` (n
// warps) orders the writes before the reads, and the reads before the
// next exchange's writes.
template <int MT>
__device__ __forceinline__ void exchange(float (&acc)[MT][2 * MT][4], float* xbuf, int warp,
                                         int first, int n, int bar, int lane) {
  constexpr int kFrags = MT * 2 * MT;
  float4* x = reinterpret_cast<float4*>(xbuf);
  float4* mine = x + (size_t)warp * kFrags * 32 + lane;
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int j = 0; j < 2 * MT; ++j)
      mine[(mt * 2 * MT + j) * 32] = make_float4(acc[mt][j][0], acc[mt][j][1], acc[mt][j][2],
                                                 acc[mt][j][3]);
  hopper::named_bar_sync(bar, 32 * n);
  zero<MT>(acc);
  for (int s = 0; s < n; ++s) {
    const float4* part = x + (size_t)(first + s) * kFrags * 32 + lane;
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int j = 0; j < 2 * MT; ++j) {
        const float4 v = part[(mt * 2 * MT + j) * 32];
        acc[mt][j][0] += v.x;
        acc[mt][j][1] += v.y;
        acc[mt][j][2] += v.z;
        acc[mt][j][3] += v.w;
      }
  }
  hopper::named_bar_sync(bar, 32 * n);
}

// out = A B (16 MT rows x w columns, w <= kMaxSlice), A as register
// fragments a[mt][t] (rows 16mt.., contracted frames 16t..), B from shared
// memory (the contracted frames' rows, ldb apart; rows >= F removed by a
// select), written times `mul` as bf16 to dst's rows < F and columns < w
// (rows ldo apart), in chunks of 64 columns. dst may be sb itself (ldo =
// ldb): a chunk's columns are written only after every lane has read them,
// and no later chunk reads them.
template <int MT>
__device__ __forceinline__ void product_stage(const uint32_t (&a)[MT][MT][4], const bf16* sb,
                                              int ldb, bf16* dst, int ldo, int F, int w,
                                              float mul, int lane) {
  constexpr int kTiles = 8;  // 8-column tiles of a chunk
#pragma unroll
  for (int n0 = 0; n0 < kMaxSlice; n0 += 64) {
    if (n0 >= w) break;
    float o[MT][kTiles][4];
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int n = 0; n < kTiles; ++n) o[mt][n][0] = o[mt][n][1] = o[mt][n][2] = o[mt][n][3] = 0.f;
#pragma unroll
    for (int t = 0; t < MT; ++t) {
#pragma unroll
      for (int np = 0; np < kTiles / 2; ++np) {
        if (n0 + 16 * np >= kMaxSlice || n0 + 16 * np >= w) break;
        uint32_t b[4];
        ldmatrix_x4_trans(b, sb + (t * 16 + (lane % 8) + ((lane / 8) % 2) * 8) * ldb + n0 +
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
    __syncwarp();  // the chunk's reads of sb before its writes to dst
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int n = 0; n < kTiles; ++n) {
        if (n0 + 8 * n >= kMaxSlice || n0 + 8 * n >= w) break;
        const int col = n0 + 8 * n + 2 * (lane % 4);
        const int row = 16 * mt + lane / 4;
        if (row < F)
          *reinterpret_cast<__nv_bfloat162*>(dst + row * ldo + col) =
              __floats2bfloat162_rn(o[mt][n][0] * mul, o[mt][n][1] * mul);
        if (row + 8 < F)
          *reinterpret_cast<__nv_bfloat162*>(dst + (row + 8) * ldo + col) =
              __floats2bfloat162_rn(o[mt][n][2] * mul, o[mt][n][3] * mul);
      }
  }
}

// ---- host: the maps -----------------------------------------------------------

// A 4-D map (d, heads * L, F, B) of a packed bf16 (B, F, L, heads * d)
// tensor: boxes of `cols` x 1 (position, head) x F frames x 1 land as
// [F][cols]; columns past the head's last read zeros.
inline int make_load_map(CUtensorMap* map, const void* ptr, int d, int heads, int L, int F,
                         int B, int cols) {
  hopper::EncodeTiledFn fn = hopper::encode_tiled();
  if (!fn) return (int)cudaErrorSymbolNotFound;
  const cuuint64_t C = (cuuint64_t)heads * d;
  const cuuint64_t dims[4] = {(cuuint64_t)d, (cuuint64_t)heads * L, (cuuint64_t)F,
                              (cuuint64_t)B};
  const cuuint64_t strides[3] = {(cuuint64_t)d * 2, (cuuint64_t)L * C * 2,
                                 (cuuint64_t)F * L * C * 2};
  const cuuint32_t box[4] = {(cuuint32_t)cols, 1, (cuuint32_t)F, 1};
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  const CUresult r = fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(ptr), dims,
                        strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
                        CU_TENSOR_MAP_SWIZZLE_NONE, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                        CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : (int)cudaErrorInvalidValue;
}

// A 5-D map (w, n slices, heads * L, F, B) of the slices at and after
// column `first` of every head of a packed bf16 (B, F, L, heads * d)
// tensor, slices CW columns apart, each w wide: a store of a padded tile
// ([F][cwp], the box cwp x 1 x 1 x F x 1) writes only its first w columns,
// and nothing past frame F.
inline int make_store_map(CUtensorMap* map, void* ptr, int d, int heads, int L, int F, int B,
                          int first, int w, int n, int CW, int cwp) {
  hopper::EncodeTiledFn fn = hopper::encode_tiled();
  if (!fn) return (int)cudaErrorSymbolNotFound;
  const cuuint64_t C = (cuuint64_t)heads * d;
  const cuuint64_t dims[5] = {(cuuint64_t)w, (cuuint64_t)n, (cuuint64_t)heads * L,
                              (cuuint64_t)F, (cuuint64_t)B};
  const cuuint64_t strides[4] = {(cuuint64_t)CW * 2, (cuuint64_t)d * 2, (cuuint64_t)L * C * 2,
                                 (cuuint64_t)F * L * C * 2};
  const cuuint32_t box[5] = {(cuuint32_t)cwp, 1, 1, (cuuint32_t)F, 1};
  const cuuint32_t elem[5] = {1, 1, 1, 1, 1};
  const CUresult r = fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 5,
                        static_cast<bf16*>(ptr) + first, dims, strides, box, elem,
                        CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE,
                        CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : (int)cudaErrorInvalidValue;
}

// The two store maps of an output: slices 0 .. slices-2 (CW wide), and
// the last slice (d - (slices - 1) * CW wide).
inline int make_store_maps(CUtensorMap (&maps)[2], void* ptr, int d, int heads, int L, int F,
                           int B, int slices, int CW, int cwp) {
  int err = make_store_map(&maps[0], ptr, d, heads, L, F, B, 0, CW, slices - 1, CW, cwp);
  if (!err)
    err = make_store_map(&maps[1], ptr, d, heads, L, F, B, (slices - 1) * CW,
                         d - (slices - 1) * CW, 1, CW, cwp);
  return err;
}

// Checks of a split launch: the plan's slices and positions, the slice
// width, the ring's stages and the bytes the wrapper reckons for them.
inline bool plan_ok(int F, int d, int slices, int positions, int CW, int cwp, int stages,
                    int least, int smem) {
  return F >= 1 && F <= 32 && slices >= 2 && positions >= 1 && slices * positions <= kWarps &&
         CW <= kMaxSlice && (slices - 1) * CW < d && cwp >= CW + 8 && stages >= least &&
         stages <= kMaxStages &&
         (size_t)smem == smem_bytes(F, cwp, stages, slices * positions) && smem <= 232448;
}

}  // namespace split

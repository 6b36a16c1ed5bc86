// Warp-level tile helpers of kernel B's long kernels (past 32 frames, the
// "long" kernels of temporal_attention*.cu): 16 x 16 products of two row
// tiles in shared memory over a head's (or a chunk's) depth, products of a
// register fragment with a row tile, the running row statistics of the
// softmax, and the store of an accumulator tile to a staging tile.
//
// Row tiles in shared memory are row-major ([rows][ld] bf16, ld an odd
// number of 16-byte units, so the eight rows one ldmatrix reads fall in
// distinct banks): a frame a row, the head's columns from some offset. The
// columns past a product's width w (the next head's, the next chunk's) are
// removed from the last 16-deep step by a select in both operands, never
// by a multiply: an Inf there stays out of this head's sums.
#pragma once

#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

#include "warp_mma.cuh"

namespace tiles {

constexpr int kPiece = 64;  // columns of one partial sum of S (added in fp32 after)

template <int NT>
__device__ __forceinline__ void zero(float (&acc)[NT][4]) {
#pragma unroll
  for (int n = 0; n < NT; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;
}

// s (16 x 16: two 8-column tiles) = A B^T over w columns (a multiple of 8):
// A is 16 rows of sa, B 16 rows of sb (rows lda / ldb apart, depth along
// the row). The sums over each kPiece columns start from zero and are
// added in fp32: the tensor cores' accumulation, not rounded to nearest,
// then spans at most 4 16-deep steps (one accumulator over a 1280-wide head
// doubled the error against the plain version).
__device__ __forceinline__ void tile_abt(float (&s)[2][4], const bf16* sa, int lda,
                                         const bf16* sb, int ldb, int w, int lane) {
  zero(s);
  const bf16* pa = sa + (lane % 16) * lda + (lane / 16) * 8;
  const bf16* pb = sb + ((lane % 8) + (lane / 16) * 8) * ldb + ((lane / 8) % 2) * 8;
  for (int off = 0; off < w; off += kPiece) {
    float part[2][4];
    zero(part);
#pragma unroll
    for (int kk = 0; kk < kPiece / 16; ++kk) {
      const int col = off + 16 * kk;
      if (col >= w) break;
      uint32_t a[4], b[4];
      ldmatrix_x4(a, pa + col);
      ldmatrix_x4(b, pb + col);
      if (col + 8 >= w) a[2] = a[3] = b[1] = b[3] = 0u;  // columns past w
      mma_bf16(part[0], a, b[0], b[1]);
      mma_bf16(part[1], a, b[2], b[3]);
    }
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] += part[j][e];
  }
}

// The same over KS 16-deep steps known at compile time (16 KS >= w), as
// straight-line code, so that the products of neighbouring tiles can
// overlap: the steps' columns at or past w are zeroed in both operands.
template <int KS>
__device__ __forceinline__ void tile_abt_k(float (&s)[2][4], const bf16* sa, int lda,
                                           const bf16* sb, int ldb, int w, int lane) {
  constexpr int PK = kPiece / 16;  // steps of a partial sum
  const bf16* pa = sa + (lane % 16) * lda + (lane / 16) * 8;
  const bf16* pb = sb + ((lane % 8) + (lane / 16) * 8) * ldb + ((lane / 8) % 2) * 8;
#pragma unroll
  for (int p0 = 0; p0 < KS; p0 += PK) {
    float part[2][4];
    zero(part);
#pragma unroll
    for (int kk = p0; kk < p0 + PK && kk < KS; ++kk) {
      const int col = 16 * kk;
      uint32_t a[4], b[4];
      ldmatrix_x4(a, pa + col);
      ldmatrix_x4(b, pb + col);
      const bool lo = col < w, hi = col + 8 < w;  // the step's two 8-column halves
      a[0] = lo ? a[0] : 0u;
      a[1] = lo ? a[1] : 0u;
      a[2] = hi ? a[2] : 0u;
      a[3] = hi ? a[3] : 0u;
      b[0] = lo ? b[0] : 0u;
      b[2] = lo ? b[2] : 0u;
      b[1] = hi ? b[1] : 0u;
      b[3] = hi ? b[3] : 0u;
      mma_bf16(part[0], a, b[0], b[1]);
      mma_bf16(part[1], a, b[2], b[3]);
    }
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = p0 ? s[j][e] + part[j][e] : part[j][e];
  }
}

// tile_abt_k of two 16-row A tiles (sa0, sa1) against one B tile, B's
// fragments loaded once.
template <int KS>
__device__ __forceinline__ void tile_abt2_k(float (&s0)[2][4], float (&s1)[2][4],
                                            const bf16* sa0, const bf16* sa1, int lda,
                                            const bf16* sb, int ldb, int w, int lane) {
  constexpr int PK = kPiece / 16;
  const int ao = (lane % 16) * lda + (lane / 16) * 8;
  const bf16* pb = sb + ((lane % 8) + (lane / 16) * 8) * ldb + ((lane / 8) % 2) * 8;
#pragma unroll
  for (int p0 = 0; p0 < KS; p0 += PK) {
    float part[2][2][4];
    zero(part[0]);
    zero(part[1]);
#pragma unroll
    for (int kk = p0; kk < p0 + PK && kk < KS; ++kk) {
      const int col = 16 * kk;
      uint32_t a0[4], a1[4], b[4];
      ldmatrix_x4(b, pb + col);
      ldmatrix_x4(a0, sa0 + ao + col);
      ldmatrix_x4(a1, sa1 + ao + col);
      const bool lo = col < w, hi = col + 8 < w;
      b[0] = lo ? b[0] : 0u;
      b[2] = lo ? b[2] : 0u;
      b[1] = hi ? b[1] : 0u;
      b[3] = hi ? b[3] : 0u;
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        uint32_t (&a)[4] = i ? a1 : a0;
        a[0] = lo ? a[0] : 0u;
        a[1] = lo ? a[1] : 0u;
        a[2] = hi ? a[2] : 0u;
        a[3] = hi ? a[3] : 0u;
        mma_bf16(part[i][0], a, b[0], b[1]);
        mma_bf16(part[i][1], a, b[2], b[3]);
      }
    }
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s0[j][e] = p0 ? s0[j][e] + part[0][j][e] : part[0][j][e];
        s1[j][e] = p0 ? s1[j][e] + part[1][j][e] : part[1][j][e];
      }
  }
}

// o[n] (n < 2 NP) += A B over 16 contracted rows, as tile_av over 16 NP
// columns, straight-line.
template <int NP>
__device__ __forceinline__ void tile_av_k(float (&o)[2 * NP][4], const uint32_t (&a)[4],
                                          const bf16* sb, int ldb, int lane) {
  const bf16* pb = sb + ((lane % 8) + ((lane / 8) % 2) * 8) * ldb + (lane / 16) * 8;
#pragma unroll
  for (int np = 0; np < NP; ++np) {
    uint32_t b[4];
    ldmatrix_x4_trans(b, pb + 16 * np);
    mma_bf16(o[2 * np], a, b[0], b[1]);
    mma_bf16(o[2 * np + 1], a, b[2], b[3]);
  }
}

// o[n] (8-column tiles n < ceil(w / 8), at most NT) += A B over 16
// contracted rows: A the fragment a (16 x 16), B 16 rows of sb (row-major,
// ldb apart), its columns 0 .. w. Columns of a 16-column pair past w land
// in o's tiles past w, which no caller stores.
template <int NT>
__device__ __forceinline__ void tile_av(float (&o)[NT][4], const uint32_t (&a)[4],
                                        const bf16* sb, int ldb, int w, int lane) {
  const bf16* pb = sb + ((lane % 8) + ((lane / 8) % 2) * 8) * ldb + (lane / 16) * 8;
#pragma unroll
  for (int np = 0; np < NT / 2; ++np) {
    if (16 * np >= w) break;
    uint32_t b[4];
    ldmatrix_x4_trans(b, pb + 16 * np);
    mma_bf16(o[2 * np], a, b[0], b[1]);
    mma_bf16(o[2 * np + 1], a, b[2], b[3]);
  }
}

// The A fragment (16 x 16, bf16) of two neighbouring 8-column accumulator
// tiles.
__device__ __forceinline__ void pack_a(uint32_t (&a)[4], const float (&lo)[4],
                                       const float (&hi)[4]) {
  a[0] = pack_bf16(lo[0], lo[1]);
  a[1] = pack_bf16(lo[2], lo[3]);
  a[2] = pack_bf16(hi[0], hi[1]);
  a[3] = pack_bf16(hi[2], hi[3]);
}

// Max and sum over the 4 lanes that share an accumulator row.
__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}

__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

// S scaled to the log2 domain, keys (columns) >= F at -inf; key0 is the
// tile's first key frame.
__device__ __forceinline__ void scale_mask_keys(float (&s)[2][4], int key0, int F,
                                                float scale_log2, int lane) {
#pragma unroll
  for (int j = 0; j < 2; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int key = key0 + 8 * j + 2 * (lane % 4) + (e & 1);
      s[j][e] = key < F ? s[j][e] * scale_log2 : -INFINITY;
    }
}

// The running row max m and the sum of exp2(s - m) of this lane's columns,
// rescaled when m moves, over one more key tile s (log2 domain). m is the
// same in the 4 lanes of a row; the caller sums the lanes' sums at the end.
// A tile that holds a key < F keeps m finite from the first tile on.
__device__ __forceinline__ void row_stats(const float (&s)[2][4], float (&m)[2],
                                          float (&lsum)[2]) {
  float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
  for (int j = 0; j < 2; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) mx[e >> 1] = fmaxf(mx[e >> 1], s[j][e]);
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const float mn = fmaxf(m[r], quad_max(mx[r]));
    lsum[r] *= exp2f(m[r] - mn);
    m[r] = mn;
  }
#pragma unroll
  for (int j = 0; j < 2; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) lsum[e >> 1] += exp2f(s[j][e] - m[e >> 1]);
}

// The accumulator tile o (16 rows x w columns, w a multiple of 8, at most
// 8 NT) times mul, as bf16, to the row-major staging tile dst ([16][w]).
template <int NT>
__device__ __forceinline__ void stage_rows(bf16* dst, const float (&o)[NT][4], int w, float mul,
                                           int lane) {
  const int row = lane / 4;
#pragma unroll
  for (int n = 0; n < NT; ++n) {
    if (8 * n >= w) break;
    const int col = 8 * n + 2 * (lane % 4);
    *reinterpret_cast<uint32_t*>(dst + row * w + col) = pack_bf16(o[n][0] * mul, o[n][1] * mul);
    *reinterpret_cast<uint32_t*>(dst + (row + 8) * w + col) =
        pack_bf16(o[n][2] * mul, o[n][3] * mul);
  }
}

}  // namespace tiles

// Tile helpers of the mma.sync kernels that take the shapes past the TMA
// kernels' tiles: kernel B past 32 frames (the "long" kernels of
// temporal_attention*.cu) and kernel A past 512 columns (the "xwide" kernels
// of flash_attention*.cu).
//
// A tile in shared memory is row-major, [rows][kLd] bf16: a depth piece of
// kPiece columns (or an output slab) plus 8 columns of pad, so a row is an
// odd number of 16-byte units and the eight rows one ldmatrix reads fall in
// distinct banks. Tiles are filled by cp.async with zeros past the source's
// rows and columns, so a 16-deep step over a piece narrower than 16 columns
// reads zeros, never the next head's columns.
#pragma once

#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

#include "warp_mma.cuh"

namespace tiles {

constexpr int kPiece = 64;       // columns of a depth piece
constexpr int kLd = kPiece + 8;  // row stride of a piece tile, in elements (144 bytes)

__host__ __device__ inline int round16(int x) { return (x + 15) / 16 * 16; }

// 16 bytes global -> shared, asynchronous; zeros where !pred (nothing read,
// `src` only has to be a valid address).
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool pred) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)),
               "l"(src), "r"(pred ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Wait until at most N of this thread's groups are in flight.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Rows [r0, r0 + R) x columns [0, round16(w)) of a source whose row r starts
// at src + r * stride, into dst ([R][ld]); rows >= nrows and columns >= w
// get zeros. Threads tid, tid + threads, ... of the caller share the copy;
// the caller commits, waits and synchronises.
template <int R>
__device__ __forceinline__ void load_rows_async(bf16* dst, int ld, const bf16* src, size_t stride,
                                                int r0, int nrows, int w, int tid, int threads) {
  const int vecs = round16(w) / 8;  // 16-byte vectors a row
  for (int i = tid; i < R * vecs; i += threads) {
    const int r = i / vecs, c = (i % vecs) * 8;
    const bool ok = r0 + r < nrows && c < w;
    cp_async16(dst + r * ld + c, ok ? src + (size_t)(r0 + r) * stride + c : src, ok);
  }
}

// acc[n] (NT tiles of 8 columns: the rows of B) += A B^T over `ksteps`
// 16-deep steps (at most kPiece / 16): A is 16 rows of sa, B NT * 8 rows of
// sb, both row-major with the depth along the row.
template <int NT>
__device__ __forceinline__ void mma_abt(float (&acc)[NT][4], const bf16* sa, int lda,
                                        const bf16* sb, int ldb, int ksteps, int lane) {
#pragma unroll
  for (int kk = 0; kk < kPiece / 16; ++kk) {
    if (kk >= ksteps) break;
    uint32_t a[4];
    ldmatrix_x4(a, sa + (lane % 16) * lda + kk * 16 + (lane / 16) * 8);
#pragma unroll
    for (int jp = 0; jp < NT / 2; ++jp) {
      uint32_t b[4];
      ldmatrix_x4(b, sb + (jp * 16 + (lane % 8) + (lane / 16) * 8) * ldb + kk * 16 +
                         ((lane / 8) % 2) * 8);
      mma_bf16(acc[2 * jp], a, b[0], b[1]);
      mma_bf16(acc[2 * jp + 1], a, b[2], b[3]);
    }
  }
}

// o[n] (NT tiles of 8 output columns) += A V over 16 contracted rows: A is
// the fragment a (16 rows x 16), V 16 rows of sv (row-major [row][column]);
// only the first `npairs` 16-column pairs of tiles.
template <int NT>
__device__ __forceinline__ void mma_av(float (&o)[NT][4], const uint32_t (&a)[4], const bf16* sv,
                                       int ldv, int npairs, int lane) {
#pragma unroll
  for (int np = 0; np < NT / 2; ++np) {
    if (np >= npairs) break;
    uint32_t b[4];
    ldmatrix_x4_trans(b, sv + ((lane % 8) + ((lane / 8) % 2) * 8) * ldv + np * 16 +
                             (lane / 16) * 8);
    mma_bf16(o[2 * np], a, b[0], b[1]);
    mma_bf16(o[2 * np + 1], a, b[2], b[3]);
  }
}

// The A fragment (16 rows x 16, bf16) of two neighbouring 8-column
// accumulator tiles.
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

template <int NT>
__device__ __forceinline__ void zero(float (&acc)[NT][4]) {
#pragma unroll
  for (int n = 0; n < NT; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;
}

// Accumulator rows row0 + lane/4 (+ 8) times mul[0] (mul[1]) to dst, row r
// at dst + r * stride, in bf16; rows >= nrows and columns >= w (a multiple
// of 8) are not written.
template <int NT>
__device__ __forceinline__ void store_acc(bf16* dst, size_t stride, const float (&o)[NT][4],
                                          int row0, int nrows, int w, const float (&mul)[2],
                                          int lane) {
#pragma unroll
  for (int n = 0; n < NT; ++n) {
    const int col = 8 * n + 2 * (lane % 4);
    if (8 * n >= w) break;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = row0 + lane / 4 + 8 * r;
      if (row < nrows)
        *reinterpret_cast<__nv_bfloat162*>(dst + (size_t)row * stride + col) =
            __floats2bfloat162_rn(o[n][2 * r] * mul[r], o[n][2 * r + 1] * mul[r]);
    }
  }
}

// ---- the long kernels' frame tiles -------------------------------------------
//
// A (b, f, l, c) tensor seen from one (sample, position, head): frame r's
// d columns start at base + r * fs. s = X Y^T over the head's depth for
// rows xt*16.. of x against rows yt*16.. of y (16 x 16, two 8-column
// tiles): each kPiece-column piece is copied into the warp's tiles ta and
// tb (zeros past F frames and past the piece), multiplied from a zero sum
// and added in fp32, so the tensor cores' accumulation, not rounded to
// nearest, spans at most 4 16-deep steps (one accumulator over a 1280-wide
// head doubled the gradients' error against the plain version).
__device__ __forceinline__ void frames_product(float (&s)[2][4], const bf16* x, int xt,
                                               const bf16* y, int yt, size_t fs, int F, int d,
                                               bf16* ta, bf16* tb, int lane) {
  zero(s);
  for (int p = 0; p * kPiece < d; ++p) {
    const int w = min(kPiece, d - p * kPiece);
    load_rows_async<16>(ta, kLd, x + p * kPiece, fs, xt * 16, F, w, lane, 32);
    load_rows_async<16>(tb, kLd, y + p * kPiece, fs, yt * 16, F, w, lane, 32);
    cp_async_commit();
    cp_async_wait<0>();
    __syncwarp();
    float part[2][4];
    zero(part);
    mma_abt<2>(part, ta, kLd, tb, kLd, round16(w) / 16, lane);
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] += part[j][e];
    __syncwarp();
  }
}

// S of frames_product scaled to the log2 domain, keys (columns) >= F at
// -inf; kt is the key tile.
__device__ __forceinline__ void scale_mask_keys(float (&s)[2][4], int kt, int F,
                                                float scale_log2, int lane) {
#pragma unroll
  for (int j = 0; j < 2; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int key = kt * 16 + 8 * j + 2 * (lane % 4) + (e & 1);
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

}  // namespace tiles

// What kernel A's backward sources share (csrc/flash_attention_bwd.cu and
// csrc/flash_attention_mid_bwd.cu): the block-wide tests of the bias and
// the LSE that their hidden-key rule rests on, the bf16 A fragments of P
// or dS, and the store of a gradient's accumulators.

#pragma once

#include <cuda_bf16.h>
#include <stdint.h>

#include "hopper.cuh"

namespace flash_bwd {

// In every thread of the block: whether every x[i], i < n, is <= hi (NaN
// is not). A block-wide barrier.
__device__ __forceinline__ bool block_all_le(const float* x, int n, float hi) {
  int ok = 1;
  for (int i = threadIdx.x; i < n; i += blockDim.x) ok &= x[i] <= hi;
  return __syncthreads_and(ok);
}

// The same for x[i] > lo.
__device__ __forceinline__ bool block_all_gt(const float* x, int n, float lo) {
  int ok = 1;
  for (int i = threadIdx.x; i < n; i += blockDim.x) ok &= x[i] > lo;
  return __syncthreads_and(ok);
}

// P (or dS) as bf16: the accumulators' n8 blocks 2t and 2t+1 form the A
// fragment of the 16-deep step t.
template <int N>
__device__ __forceinline__ void pack_a(uint32_t (&a)[N / 16][4], const float (&x)[N / 2]) {
#pragma unroll
  for (int t = 0; t < N / 16; ++t)
#pragma unroll
    for (int i = 0; i < 4; ++i)
      a[t][i] = hopper::pack_bf16x2(x[8 * t + 2 * i], x[8 * t + 2 * i + 1]);
}

// Store this warp's rows (row0 + lane/4, +8) of a 64 x N accumulator of one
// head as bf16, times `mul`, skipping rows >= valid_rows and columns >= cols.
template <int N>
__device__ __forceinline__ void store_acc(bf16* dst, int C_all, const float (&acc)[N / 2],
                                          int row0, int valid_rows, int cols, float mul,
                                          int lane) {
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + lane / 4 + 8 * r;
    if (row >= valid_rows) continue;
#pragma unroll
    for (int j = 0; j < N / 8; ++j) {
      const int col = 8 * j + 2 * (lane % 4);
      if (col < cols)
        *reinterpret_cast<__nv_bfloat162*>(dst + (size_t)row * C_all + col) =
            __floats2bfloat162_rn(acc[4 * j + 2 * r] * mul, acc[4 * j + 2 * r + 1] * mul);
    }
  }
}

}  // namespace flash_bwd

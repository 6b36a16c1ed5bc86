// Transposed flash attention forward (the layout probe), packed heads, bf16,
// for Hopper (sm_90a).
//
// Replaces: tools/microbench.py, `probe_pvt`'s Pallas kernel `kernel_t`
// (launched by its `flash_t`): a flash forward computed transposed,
// logits^T = K Q^T with the softmax taken down each column, and
// acc^T = [V^T; 1] P^T, which yields out and the row sums at once. It is a
// standalone copy of kernel A's function, kept to time the orientation
// against kernel A (csrc/flash_attention.cu); no path of the port runs it.
//
// Computes, for each batch row b, head h and query column, with q already
// scaled by d^-1/2 * log2(e) and rounded to bf16 by the wrapper (as the JAX
// probe folds the scale into q):
//   s^T = k_h qs_h^T + bias[b] * log2(e)   (keys down, queries across)
//   m = max over keys, l = sum over keys of p, p = exp2(s^T - m)
//   out_h = (v_h^T p / l)^T,   lse = m + log2(l)   (log2 units)
// in an online pass over 64-key tiles, p rounded to bf16 before the PV
// product and l summed from p in fp32. q/out are (B, Lq, heads*d), k/v
// (B, Lk, heads*d), bias fp32 (B, Lk) or absent, lse fp32 (B, heads, Lq).
//
// What bounds it on the H100: the tensor cores, as kernel A (4 * Lq * Lk *
// d FLOPs per head, 2.3 TFLOP at 24 x 8 heads x 6144 x 12288, d = 40,
// against ~0.1 GB of traffic).
//
// Design: one block of 4 warps per (64-query tile, head, batch row); each
// warp owns 16 queries, which are the COLUMNS of its products. Per key tile
// a warp computes s^T (64 keys x 16 queries: 4 x 2 m16n8 accumulators, its
// B operand Q^T held in registers for the whole loop), so the softmax runs
// down columns: each thread reduces its 8 values of a column, then the 8
// lanes that share the column (lane % 4) reduce by shuffles. The PV product
// is O^T (d x 16 queries) += V^T (d x 64 keys) P^T: V^T comes from the
// shared key-major V tile by `ldmatrix.trans`, and P^T's accumulator
// fragments, which are not laid out as the B operand, are transposed 8 x 8
// at a time in registers by `movmatrix.trans` (sm_75 and later). d = 40 is
// the output's row axis here, padded to 48 (three m16 tiles); the row sums
// stay in fp32 registers (the TPU probe folds them in as a ones row of
// V^T). O^T is transposed back by `movmatrix` before its 4-byte stores.
// Ragged Lq and Lk are masked in the kernel.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

#include "warp_mma.cuh"

namespace {

constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int BQ = 16 * kWarps;  // queries per block
constexpr int BK = 64;           // keys per tile
constexpr float kLog2e = 1.4426950408889634f;

__device__ __forceinline__ uint32_t movmatrix_trans(uint32_t x) {
  uint32_t y;
  asm volatile("movmatrix.sync.aligned.m8n8.trans.b16 %0, %1;\n" : "=r"(y) : "r"(x));
  return y;
}

__device__ __forceinline__ void load_tile(bf16* dst, int lds, const bf16* src, int ld, int rows,
                                          int cols, int valid_rows, int valid_cols) {
  const int vecs = cols / 8;
  for (int e = threadIdx.x; e < rows * vecs; e += kThreads) {
    const int r = e / vecs;
    const int c = (e % vecs) * 8;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (r < valid_rows && c < valid_cols) {
      val = *reinterpret_cast<const uint4*>(src + (size_t)r * ld + c);
    }
    *reinterpret_cast<uint4*>(dst + r * lds + c) = val;
  }
}

// DQK: d padded to a multiple of 16.
template <int DQK>
__global__ void __launch_bounds__(kThreads)
probe_pvt_kernel(const bf16* __restrict__ qs, const bf16* __restrict__ k,
                 const bf16* __restrict__ v, const float* __restrict__ bias,
                 bf16* __restrict__ out, float* __restrict__ lse, int Lq, int Lk, int heads,
                 int d) {
  constexpr int LD = DQK + 8;  // an odd multiple of 16 bytes
  constexpr int KD = DQK / 16;
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* sQ = reinterpret_cast<bf16*>(smem);
  bf16* sK = sQ + BQ * LD;
  bf16* sV = sK + BK * LD;
  float* sB = reinterpret_cast<float*>(sV + BK * LD);

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int q0 = blockIdx.x * BQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int C = heads * d;
  const bf16* kb = k + (size_t)b * Lk * C + (size_t)h * d;
  const bf16* vb = v + (size_t)b * Lk * C + (size_t)h * d;

  load_tile(sQ, LD, qs + ((size_t)b * Lq + q0) * C + (size_t)h * d, C, BQ, DQK, Lq - q0, d);
  __syncthreads();
  // B operand Q^T (d x this warp's 16 queries): [kk][0..1] queries 0-7,
  // [kk][2..3] queries 8-15
  uint32_t qf[KD][4];
#pragma unroll
  for (int kk = 0; kk < KD; ++kk)
    ldmatrix_x4(qf[kk], sQ + (16 * warp + lane % 8 + (lane / 16) * 8) * LD + kk * 16 +
                            ((lane / 8) % 2) * 8);

  // per-thread state of its 4 query columns [n-tile][c]: column
  // 16*warp + 8*nt + 2*(lane%4) + c
  float o[KD][2][4];
#pragma unroll
  for (int m = 0; m < KD; ++m)
#pragma unroll
    for (int n = 0; n < 2; ++n) o[m][n][0] = o[m][n][1] = o[m][n][2] = o[m][n][3] = 0.f;
  float m_col[2][2], l_col[2][2];
#pragma unroll
  for (int n = 0; n < 2; ++n) m_col[n][0] = m_col[n][1] = -INFINITY, l_col[n][0] = l_col[n][1] = 0.f;

  for (int k0 = 0; k0 < Lk; k0 += BK) {
    __syncthreads();  // the previous tile's readers of sK/sV/sB are done
    load_tile(sK, LD, kb + (size_t)k0 * C, C, BK, DQK, Lk - k0, d);
    load_tile(sV, LD, vb + (size_t)k0 * C, C, BK, DQK, Lk - k0, d);
    for (int c = threadIdx.x; c < BK; c += kThreads) {
      const int key = k0 + c;
      sB[c] = key >= Lk ? -INFINITY : (bias ? bias[(size_t)b * Lk + key] * kLog2e : 0.f);
    }
    __syncthreads();

    // s^T = K Q^T: element e of st[mt][nt] is key 16*mt + lane/4 + 8*(e>>1),
    // query column 8*nt + 2*(lane%4) + (e&1) of the warp's 16
    float st[4][2][4];
#pragma unroll
    for (int mt = 0; mt < 4; ++mt) {
#pragma unroll
      for (int n = 0; n < 2; ++n) st[mt][n][0] = st[mt][n][1] = st[mt][n][2] = st[mt][n][3] = 0.f;
#pragma unroll
      for (int kk = 0; kk < KD; ++kk) {
        uint32_t a[4];
        ldmatrix_x4(a, sK + (16 * mt + lane % 16) * LD + kk * 16 + (lane / 16) * 8);
        mma_bf16(st[mt][0], a, qf[kk][0], qf[kk][1]);
        mma_bf16(st[mt][1], a, qf[kk][2], qf[kk][3]);
      }
    }

    // the softmax down each column: in-thread over 8 keys, then across the
    // 8 lanes of equal lane % 4
    float mx[2][2] = {{-INFINITY, -INFINITY}, {-INFINITY, -INFINITY}};
#pragma unroll
    for (int mt = 0; mt < 4; ++mt)
#pragma unroll
      for (int n = 0; n < 2; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          st[mt][n][e] += sB[16 * mt + lane / 4 + 8 * (e >> 1)];
          mx[n][e & 1] = fmaxf(mx[n][e & 1], st[mt][n][e]);
        }
    float m_use[2][2], alpha[2][2];
#pragma unroll
    for (int n = 0; n < 2; ++n)
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        float x = mx[n][c];
        x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 4));
        x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 8));
        x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 16));
        const float m_new = fmaxf(m_col[n][c], x);
        // a column whose keys are all masked so far keeps p = 0, alpha = 0
        m_use[n][c] = m_new == -INFINITY ? 0.f : m_new;
        alpha[n][c] = exp2f(m_col[n][c] - m_use[n][c]);
        m_col[n][c] = m_new;
        l_col[n][c] *= alpha[n][c];
      }
#pragma unroll
    for (int mt = 0; mt < 4; ++mt)
#pragma unroll
      for (int n = 0; n < 2; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          st[mt][n][e] = exp2f(st[mt][n][e] - m_use[n][e & 1]);
          l_col[n][e & 1] += st[mt][n][e];
        }
#pragma unroll
    for (int m = 0; m < KD; ++m)
#pragma unroll
      for (int n = 0; n < 2; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) o[m][n][e] *= alpha[n][e & 1];

    // O^T += V^T P^T over the tile's 4 steps of 16 keys; P^T's fragment of
    // keys 16t.. (rows g, g + 8) becomes the B operand by an 8 x 8 transpose
#pragma unroll
    for (int t = 0; t < 4; ++t) {
      uint32_t pb[2][2];
#pragma unroll
      for (int n = 0; n < 2; ++n) {
        pb[n][0] = movmatrix_trans(pack_bf16(st[t][n][0], st[t][n][1]));
        pb[n][1] = movmatrix_trans(pack_bf16(st[t][n][2], st[t][n][3]));
      }
#pragma unroll
      for (int m = 0; m < KD; ++m) {
        uint32_t a[4];
        ldmatrix_x4_trans(a, sV + (16 * t + lane % 8 + (lane / 16) * 8) * LD + 16 * m +
                                 ((lane / 8) % 2) * 8);
        mma_bf16(o[m][0], a, pb[0][0], pb[0][1]);
        mma_bf16(o[m][1], a, pb[1][0], pb[1][1]);
      }
    }
  }

  // finish the column sums across the 8 lanes that share a column
#pragma unroll
  for (int n = 0; n < 2; ++n)
#pragma unroll
    for (int c = 0; c < 2; ++c) {
      l_col[n][c] += __shfl_xor_sync(0xffffffffu, l_col[n][c], 4);
      l_col[n][c] += __shfl_xor_sync(0xffffffffu, l_col[n][c], 8);
      l_col[n][c] += __shfl_xor_sync(0xffffffffu, l_col[n][c], 16);
    }
  // out: O^T / l rounded to bf16 and transposed back 8 x 8 by movmatrix;
  // afterwards a thread holds query 8*nt + lane/4, head columns
  // 16*m + 8*half + 2*(lane%4) .. +1
#pragma unroll
  for (int n = 0; n < 2; ++n) {
    const int row = q0 + 16 * warp + 8 * n + lane / 4;
    const float inv0 = 1.f / l_col[n][0], inv1 = 1.f / l_col[n][1];
    bf16* orow = out + ((size_t)b * Lq + row) * C + (size_t)h * d;
#pragma unroll
    for (int m = 0; m < KD; ++m)
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const uint32_t t = movmatrix_trans(
            pack_bf16(o[m][n][2 * half] * inv0, o[m][n][2 * half + 1] * inv1));
        const int col = 16 * m + 8 * half + 2 * (lane % 4);
        if (row < Lq && col < d) *reinterpret_cast<uint32_t*>(orow + col) = t;
      }
    if (lane < 4) {
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        const int q = q0 + 16 * warp + 8 * n + 2 * lane + c;
        if (q < Lq) lse[((size_t)b * heads + h) * Lq + q] = m_col[n][c] + log2f(l_col[n][c]);
      }
    }
  }
}

template <int DQK>
int launch(const void* qs, const void* k, const void* v, const void* bias, void* out, void* lse,
           int B, int Lq, int Lk, int heads, int d, cudaStream_t stream) {
  const size_t bytes = sizeof(bf16) * (BQ + 2 * BK) * (DQK + 8) + sizeof(float) * BK;
  const dim3 grid((Lq + BQ - 1) / BQ, heads, B);
  probe_pvt_kernel<DQK><<<grid, kThreads, bytes, stream>>>(
      static_cast<const bf16*>(qs), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<const float*>(bias), static_cast<bf16*>(out), static_cast<float*>(lse), Lq,
      Lk, heads, d);
  return (int)cudaGetLastError();
}

}  // namespace

// Head widths: d a multiple of 8 with d <= 80 (padded to 48 / 80).
extern "C" int hv_probe_pvt(const void* qs, const void* k, const void* v, const void* bias,
                            void* out, void* lse, int B, int Lq, int Lk, int heads, int d,
                            void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (d <= 0 || d % 8 != 0) return (int)cudaErrorInvalidValue;
  if (d <= 48) return launch<48>(qs, k, v, bias, out, lse, B, Lq, Lk, heads, d, s);
  if (d <= 80) return launch<80>(qs, k, v, bias, out, lse, B, Lq, Lk, heads, d, s);
  return (int)cudaErrorInvalidValue;
}

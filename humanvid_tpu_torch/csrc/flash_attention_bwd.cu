// Flash attention backward, packed heads, bf16, for Hopper (sm_90a).
//
// Replaces: humanvid_tpu/ops/flash_attention.py, the Pallas kernels
// `_dkv_kernel_t` (dk/dv) and `_dq_kernel_t` (dq), both launched by
// `_flash_bwd_kernel` for heads with d <= 128, and the straight-layout
// `_dkv_kernel` and `_dq_kernel` it takes for d > 128 (here d = 512, the
// VAE mid block's single head).
//
// Computes the gradient of out_h = softmax(q_h k_h^T * d^-1/2 + bias[b]) v_h
// (the forward of csrc/flash_attention.cu) given g = dL/dout, the forward's
// per-(row, head) log-sum-exp `lse` (B, heads, Lq) in NATURAL-log units and
// delta = rowsum(g * out) per (row, head) (B, heads, Lq), fp32:
//   p  = exp2((s * scale + bias) * log2e - lse * log2e),   s = q_h k_h^T
//   dv = p^T g_h
//   ds = p * (g_h v_h^T - delta)
//   dk = ds^T q_h * scale,   dq = ds k_h * scale
// with p and ds rounded to bf16 before their products, as the JAX kernels
// do. q/g/dq are (B, Lq, heads*d), k/v/dk/dv (B, Lk, heads*d), the bias is
// fp32 (B, Lk) or absent. A key hidden by a -1e9 bias gets p == 0 exactly
// in every row, hence exactly zero dk and dv.
//
// What bounds it on the H100: the five (Lq x Lk x d) products per head
// (recomputed s, dp, dv, dk, dq; 10 * Lq * Lk * d FLOPs, ~7.9 TFLOP at the
// stage-2 level-0 shape, ~1.5 TFLOP at the VAE's 8 x 6144 x 6144, d = 512)
// against ~0.2 GB of q/k/v/out/g/dq/dk/dv/lse/delta traffic: the tensor
// cores bound it, as long as no (Lq x Lk) matrix ever reaches device memory.
//
// The simple design (the FlashAttention-2 split, as in the JAX package, with
// no atomics, so the result is deterministic): two kernels of 4 warps.
//   dk/dv: one block per (64-key tile, head, batch row) keeps its K and V
//     tile in shared memory and loops over every 64-row q tile (the loop
//     takes the place of the TPU's sequential grid axis); each warp owns 16
//     keys and works in the transposed orientation, s^T = K Q^T, so that
//     its keys' dK and dV rows accumulate in its own fp32 registers over
//     the whole loop and are written once, in bf16.
//   dq: one block per (64-row q tile, head, batch row) loops over the
//     64-key tiles; each warp owns 16 q rows and accumulates dQ in
//     registers.
// Every product is `mma.sync.m16n8k16` (bf16 in, fp32 accumulate) with
// operands from `ldmatrix` (`.trans` where the operand is the transpose of
// what shared memory holds); an accumulator fragment is re-packed in
// registers as the A operand of the next product. Head widths are
// zero-padded to 48 or 80 in shared memory and ragged Lq / Lk are masked in
// the kernel: padded q rows carry zero g and delta and contribute nothing,
// padded keys get p = 0 in the dq kernel and are not stored by the dk/dv
// kernel. No wgmma, TMA or cp.async pipelining yet.
//
// The wide head (d = 512): a 64 x 512 fp32 accumulator per warp group does
// not fit the registers, so, as the forward splits its v/out columns, each
// block owns one 128-column chunk of the gradient it writes (grid axis y is
// head x chunk). A dk/dv block (64 keys, one chunk) recomputes s^T = K Q^T
// and dp^T = V G^T over all 512 columns, streaming 64-column slices of k,
// v, q and g through shared memory, then accumulates dV[:, chunk] += P^T
// G[:, chunk] and dK[:, chunk] += dS^T Q[:, chunk]; a dq block (64 rows,
// one chunk) does the same with s = Q K^T, dp = G V^T and dQ[:, chunk] +=
// dS K[:, chunk]. Each of the four chunks recomputes s and dp, so the
// kernels do 4 * (2 * 512 + 2 * 128) + 4 * (2 * 512 + 128) = 9728 against
// the 5 * 512 = 2560 multiply-adds per (q, key) pair the gradient needs:
// ~3.8x the least product work. The other route, 512-wide fp32
// accumulators in shared memory (128 KB for 32 keys), recomputes nothing
// but holds one block per SM; it is left for a faster version.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

#include "warp_mma.cuh"

namespace {

constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr int BQ = 16 * kWarps;  // q rows per tile
constexpr int BK = 16 * kWarps;  // keys per tile
constexpr float kLog2e = 1.4426950408889634f;

// Copy `rows` rows of `cols` columns (a multiple of 8) starting at `src`
// (row stride `ld` elements) into a shared tile with row stride `lds`;
// rows >= valid_rows and columns >= valid_cols are zero.
__device__ __forceinline__ void load_tile(bf16* dst, int lds, const bf16* src, int ld,
                                          int rows, int cols, int valid_rows,
                                          int valid_cols) {
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

// acc[16 x 64] += A[16 x D] * B^T where A is this warp's 16 rows of a
// shared tile (row stride LD) and B the 64 rows of another: the
// "rows x rows" product (s = q k^T, dp = g v^T, and their transposes).
template <int D>
__device__ __forceinline__ void rows_by_rows(float (&acc)[8][4], const bf16* a_rows,
                                             const bf16* b_rows, int lane) {
  constexpr int LD = D + 8;
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    uint32_t a[4];
    ldmatrix_x4(a, a_rows + (lane % 16) * LD + kk * 16 + (lane / 16) * 8);
#pragma unroll
    for (int jp = 0; jp < 4; ++jp) {
      uint32_t b[4];
      ldmatrix_x4(b, b_rows + (jp * 16 + (lane % 8) + (lane / 16) * 8) * LD + kk * 16 +
                         ((lane / 8) % 2) * 8);
      mma_bf16(acc[2 * jp], a, b[0], b[1]);
      mma_bf16(acc[2 * jp + 1], a, b[2], b[3]);
    }
  }
}

// acc[16 x D] += P[16 x 64] * B[64 x D]: P is a 16 x 64 accumulator
// fragment (rounded to bf16 here), B a shared tile of 64 rows (row stride
// LD) read through ldmatrix.trans.
template <int D>
__device__ __forceinline__ void frag_by_tile(float (&acc)[D / 8][4], const float (&p)[8][4],
                                             const bf16* b_rows, int lane) {
  constexpr int LD = D + 8;
#pragma unroll
  for (int t = 0; t < 4; ++t) {
    uint32_t a[4];
    a[0] = pack_bf16(p[2 * t][0], p[2 * t][1]);
    a[1] = pack_bf16(p[2 * t][2], p[2 * t][3]);
    a[2] = pack_bf16(p[2 * t + 1][0], p[2 * t + 1][1]);
    a[3] = pack_bf16(p[2 * t + 1][2], p[2 * t + 1][3]);
#pragma unroll
    for (int np = 0; np < D / 16; ++np) {
      uint32_t b[4];
      ldmatrix_x4_trans(b, b_rows + (t * 16 + (lane % 8) + ((lane / 8) % 2) * 8) * LD +
                               np * 16 + (lane / 16) * 8);
      mma_bf16(acc[2 * np], a, b[0], b[1]);
      mma_bf16(acc[2 * np + 1], a, b[2], b[3]);
    }
  }
}

// Store this warp's 16 x D accumulator rows (row0 + lane/4, +8) of one head
// as bf16, times `mul`, skipping rows >= valid_rows and columns >= d.
template <int D>
__device__ __forceinline__ void store_rows(bf16* dst, int C, const float (&acc)[D / 8][4],
                                           int row0, int valid_rows, int d, float mul,
                                           int lane) {
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + lane / 4 + 8 * r;
    if (row >= valid_rows) continue;
#pragma unroll
    for (int n = 0; n < D / 8; ++n) {
      const int col = 8 * n + 2 * (lane % 4);
      if (col < d) {
        *reinterpret_cast<__nv_bfloat162*>(dst + (size_t)row * C + col) =
            __floats2bfloat162_rn(acc[n][2 * r] * mul, acc[n][2 * r + 1] * mul);
      }
    }
  }
}

// dk/dv: grid (key tiles, heads, B). Element e of accumulator tile j is
// key row 16*warp + lane/4 + 8*(e>>1) and q column 8j + 2*(lane%4) + (e&1).
template <int D>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dkv_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                     const bf16* __restrict__ v, const float* __restrict__ bias,
                     const bf16* __restrict__ g, const float* __restrict__ lse,
                     const float* __restrict__ delta, bf16* __restrict__ dk,
                     bf16* __restrict__ dv, int Lq, int Lk, int heads, int d,
                     float scale_log2, float scale) {
  constexpr int LD = D + 8;  // an odd multiple of 16 bytes: ldmatrix conflict-free
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* sK = reinterpret_cast<bf16*>(smem);
  bf16* sV = sK + BK * LD;
  bf16* sQ = sV + BK * LD;
  bf16* sG = sQ + BQ * LD;
  float* sL = reinterpret_cast<float*>(sG + BQ * LD);  // lse * log2e per q row
  float* sD = sL + BQ;                                 // delta per q row

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int k0 = blockIdx.x * BK;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int C = heads * d;
  const size_t head = (size_t)h * d;
  const bf16* qb = q + (size_t)b * Lq * C + head;
  const bf16* gb = g + (size_t)b * Lq * C + head;
  const float* lse_b = lse + ((size_t)b * heads + h) * Lq;
  const float* delta_b = delta + ((size_t)b * heads + h) * Lq;

  load_tile(sK, LD, k + ((size_t)b * Lk + k0) * C + head, C, BK, D, Lk - k0, d);
  load_tile(sV, LD, v + ((size_t)b * Lk + k0) * C + head, C, BK, D, Lk - k0, d);
  float key_bias[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int key = k0 + 16 * warp + lane / 4 + 8 * r;
    key_bias[r] = (bias && key < Lk) ? bias[(size_t)b * Lk + key] * kLog2e : 0.f;
  }

  float dk_acc[D / 8][4], dv_acc[D / 8][4];
#pragma unroll
  for (int n = 0; n < D / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk_acc[n][e] = dv_acc[n][e] = 0.f;

  const bf16* k_warp = sK + 16 * warp * LD;
  const bf16* v_warp = sV + 16 * warp * LD;
  for (int q0 = 0; q0 < Lq; q0 += BQ) {
    __syncthreads();  // the previous tile's readers of sQ/sG/sL/sD are done
    load_tile(sQ, LD, qb + (size_t)q0 * C, C, BQ, D, Lq - q0, d);
    load_tile(sG, LD, gb + (size_t)q0 * C, C, BQ, D, Lq - q0, d);
    for (int c = threadIdx.x; c < BQ; c += kThreads) {
      const bool valid = q0 + c < Lq;
      sL[c] = valid ? lse_b[q0 + c] * kLog2e : 0.f;
      sD[c] = valid ? delta_b[q0 + c] : 0.f;
    }
    __syncthreads();

    // p^T = exp2(s^T * scale*log2e + bias*log2e - lse*log2e), s^T = K Q^T
    float p[8][4];
#pragma unroll
    for (int j = 0; j < 8; ++j) p[j][0] = p[j][1] = p[j][2] = p[j][3] = 0.f;
    rows_by_rows<D>(p, k_warp, sQ, lane);
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        p[j][e] = exp2f(p[j][e] * scale_log2 + key_bias[e >> 1] -
                        sL[8 * j + 2 * (lane % 4) + (e & 1)]);

    frag_by_tile<D>(dv_acc, p, sG, lane);  // dV += P^T G

    // ds^T = p^T * (dp^T - delta), dp^T = V G^T
    float ds[8][4];
#pragma unroll
    for (int j = 0; j < 8; ++j) ds[j][0] = ds[j][1] = ds[j][2] = ds[j][3] = 0.f;
    rows_by_rows<D>(ds, v_warp, sG, lane);
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        ds[j][e] = p[j][e] * (ds[j][e] - sD[8 * j + 2 * (lane % 4) + (e & 1)]);

    frag_by_tile<D>(dk_acc, ds, sQ, lane);  // dK += dS^T Q
  }

  store_rows<D>(dk + (size_t)b * Lk * C + head, C, dk_acc, k0 + 16 * warp, Lk, d, scale, lane);
  store_rows<D>(dv + (size_t)b * Lk * C + head, C, dv_acc, k0 + 16 * warp, Lk, d, 1.f, lane);
}

// dq: grid (q tiles, heads, B). Element e of accumulator tile j is q row
// 16*warp + lane/4 + 8*(e>>1) and key column 8j + 2*(lane%4) + (e&1).
template <int D>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dq_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                    const bf16* __restrict__ v, const float* __restrict__ bias,
                    const bf16* __restrict__ g, const float* __restrict__ lse,
                    const float* __restrict__ delta, bf16* __restrict__ dq, int Lq,
                    int Lk, int heads, int d, float scale_log2, float scale) {
  constexpr int LD = D + 8;
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* sQ = reinterpret_cast<bf16*>(smem);
  bf16* sG = sQ + BQ * LD;
  bf16* sK = sG + BQ * LD;
  bf16* sV = sK + BK * LD;
  float* sB = reinterpret_cast<float*>(sV + BK * LD);  // bias * log2e per key

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int q0 = blockIdx.x * BQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int C = heads * d;
  const size_t head = (size_t)h * d;
  const bf16* kb = k + (size_t)b * Lk * C + head;
  const bf16* vb = v + (size_t)b * Lk * C + head;

  load_tile(sQ, LD, q + ((size_t)b * Lq + q0) * C + head, C, BQ, D, Lq - q0, d);
  load_tile(sG, LD, g + ((size_t)b * Lq + q0) * C + head, C, BQ, D, Lq - q0, d);
  float row_lse[2], row_delta[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = q0 + 16 * warp + lane / 4 + 8 * r;
    const size_t at = ((size_t)b * heads + h) * Lq + row;
    row_lse[r] = row < Lq ? lse[at] * kLog2e : 0.f;
    row_delta[r] = row < Lq ? delta[at] : 0.f;
  }

  float dq_acc[D / 8][4];
#pragma unroll
  for (int n = 0; n < D / 8; ++n) dq_acc[n][0] = dq_acc[n][1] = dq_acc[n][2] = dq_acc[n][3] = 0.f;

  const bf16* q_warp = sQ + 16 * warp * LD;
  const bf16* g_warp = sG + 16 * warp * LD;
  for (int k0 = 0; k0 < Lk; k0 += BK) {
    __syncthreads();  // the previous tile's readers of sK/sV/sB are done
    load_tile(sK, LD, kb + (size_t)k0 * C, C, BK, D, Lk - k0, d);
    load_tile(sV, LD, vb + (size_t)k0 * C, C, BK, D, Lk - k0, d);
    for (int c = threadIdx.x; c < BK; c += kThreads) {
      const int key = k0 + c;
      sB[c] = key >= Lk ? -INFINITY : (bias ? bias[(size_t)b * Lk + key] * kLog2e : 0.f);
    }
    __syncthreads();

    float p[8][4];
#pragma unroll
    for (int j = 0; j < 8; ++j) p[j][0] = p[j][1] = p[j][2] = p[j][3] = 0.f;
    rows_by_rows<D>(p, q_warp, sK, lane);  // s = Q K^T
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        p[j][e] = exp2f(p[j][e] * scale_log2 + sB[8 * j + 2 * (lane % 4) + (e & 1)] -
                        row_lse[e >> 1]);

    float ds[8][4];
#pragma unroll
    for (int j = 0; j < 8; ++j) ds[j][0] = ds[j][1] = ds[j][2] = ds[j][3] = 0.f;
    rows_by_rows<D>(ds, g_warp, sV, lane);  // dp = G V^T
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) ds[j][e] = p[j][e] * (ds[j][e] - row_delta[e >> 1]);

    frag_by_tile<D>(dq_acc, ds, sK, lane);  // dQ += dS K
  }

  store_rows<D>(dq + (size_t)b * Lq * C + head, C, dq_acc, q0 + 16 * warp, Lq, d, scale, lane);
}

// The wide head: K-dim slices of 64 columns streamed through shared memory
// for the recomputed products, 128-column chunks of the gradient per block.
constexpr int WS = 64;        // columns of one streamed slice
constexpr int WC = 128;       // gradient columns one block owns
constexpr int LWS = WS + 8;   // shared row strides, odd multiples of 16 bytes
constexpr int LWC = WC + 8;

// acc1 += A1 B1^T and acc2 += A2 B2^T over all d columns for this warp's 16
// rows of A (its rows `a_row0..+16` of the 64-row tiles) against the 64 rows
// of B: a1/a2 (rows of A, valid_a of them) and b1/b2 (valid_b rows) point at
// column 0 of their tiles in device memory, row stride C. Each 64-column
// slice of the four tiles passes through shared memory once.
__device__ __forceinline__ void wide_pair(float (&acc1)[8][4], float (&acc2)[8][4],
                                          bf16* sA1, bf16* sA2, bf16* sB1, bf16* sB2,
                                          const bf16* a1, const bf16* a2, int valid_a,
                                          const bf16* b1, const bf16* b2, int valid_b,
                                          int C, int d, int warp, int lane) {
  for (int c0 = 0; c0 < d; c0 += WS) {
    __syncthreads();  // the previous slice's readers are done
    load_tile(sA1, LWS, a1 + c0, C, BQ, WS, valid_a, d - c0);
    load_tile(sA2, LWS, a2 + c0, C, BQ, WS, valid_a, d - c0);
    load_tile(sB1, LWS, b1 + c0, C, BK, WS, valid_b, d - c0);
    load_tile(sB2, LWS, b2 + c0, C, BK, WS, valid_b, d - c0);
    __syncthreads();
    rows_by_rows<WS>(acc1, sA1 + 16 * warp * LWS, sB1, lane);
    rows_by_rows<WS>(acc2, sA2 + 16 * warp * LWS, sB2, lane);
  }
}

// dk/dv of a wide head: grid (key tiles, heads * chunks, B). Accumulator
// elements as in flash_bwd_dkv_kernel, over one WC-column chunk.
__global__ void __launch_bounds__(kThreads)
flash_bwd_dkv_wide_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                          const bf16* __restrict__ v, const float* __restrict__ bias,
                          const bf16* __restrict__ g, const float* __restrict__ lse,
                          const float* __restrict__ delta, bf16* __restrict__ dk,
                          bf16* __restrict__ dv, int Lq, int Lk, int heads, int d,
                          float scale_log2, float scale) {
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* sK = reinterpret_cast<bf16*>(smem);  // streamed slices
  bf16* sV = sK + BK * LWS;
  bf16* sQ = sV + BK * LWS;
  bf16* sG = sQ + BQ * LWS;
  bf16* sQc = sG + BQ * LWS;                 // this block's chunk of q and g
  bf16* sGc = sQc + BQ * LWC;
  float* sL = reinterpret_cast<float*>(sGc + BQ * LWC);
  float* sD = sL + BQ;

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int n_chunks = (d + WC - 1) / WC;
  const int k0 = blockIdx.x * BK;
  const int h = blockIdx.y / n_chunks;
  const int v0 = (blockIdx.y % n_chunks) * WC;
  const int b = blockIdx.z;
  const int C = heads * d;
  const size_t head = (size_t)h * d;
  const bf16* kb = k + ((size_t)b * Lk + k0) * C + head;
  const bf16* vb = v + ((size_t)b * Lk + k0) * C + head;
  const bf16* qb = q + (size_t)b * Lq * C + head;
  const bf16* gb = g + (size_t)b * Lq * C + head;
  const float* lse_b = lse + ((size_t)b * heads + h) * Lq;
  const float* delta_b = delta + ((size_t)b * heads + h) * Lq;

  float key_bias[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int key = k0 + 16 * warp + lane / 4 + 8 * r;
    key_bias[r] = (bias && key < Lk) ? bias[(size_t)b * Lk + key] * kLog2e : 0.f;
  }
  float dk_acc[WC / 8][4], dv_acc[WC / 8][4];
#pragma unroll
  for (int n = 0; n < WC / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk_acc[n][e] = dv_acc[n][e] = 0.f;

  for (int q0 = 0; q0 < Lq; q0 += BQ) {
    // p^T from s^T = K Q^T and dp^T = V G^T over all d columns; the
    // syncs inside also order this tile's chunk loads after the previous
    // tile's readers
    float p[8][4], ds[8][4];
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) p[j][e] = ds[j][e] = 0.f;
    wide_pair(p, ds, sK, sV, sQ, sG, kb, vb, Lk - k0, qb + (size_t)q0 * C,
              gb + (size_t)q0 * C, Lq - q0, C, d, warp, lane);
    load_tile(sQc, LWC, qb + (size_t)q0 * C + v0, C, BQ, WC, Lq - q0, d - v0);
    load_tile(sGc, LWC, gb + (size_t)q0 * C + v0, C, BQ, WC, Lq - q0, d - v0);
    for (int c = threadIdx.x; c < BQ; c += kThreads) {
      const bool valid = q0 + c < Lq;
      sL[c] = valid ? lse_b[q0 + c] * kLog2e : 0.f;
      sD[c] = valid ? delta_b[q0 + c] : 0.f;
    }
    __syncthreads();

#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = 8 * j + 2 * (lane % 4) + (e & 1);
        p[j][e] = exp2f(p[j][e] * scale_log2 + key_bias[e >> 1] - sL[col]);
        ds[j][e] = p[j][e] * (ds[j][e] - sD[col]);
      }
    frag_by_tile<WC>(dv_acc, p, sGc, lane);   // dV[:, chunk] += P^T G[:, chunk]
    frag_by_tile<WC>(dk_acc, ds, sQc, lane);  // dK[:, chunk] += dS^T Q[:, chunk]
    __syncthreads();  // the readers of sQc/sGc/sL/sD are done
  }

  const size_t out0 = (size_t)b * Lk * C + head + v0;
  store_rows<WC>(dk + out0, C, dk_acc, k0 + 16 * warp, Lk, d - v0, scale, lane);
  store_rows<WC>(dv + out0, C, dv_acc, k0 + 16 * warp, Lk, d - v0, 1.f, lane);
}

// dq of a wide head: grid (q tiles, heads * chunks, B).
__global__ void __launch_bounds__(kThreads)
flash_bwd_dq_wide_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                         const bf16* __restrict__ v, const float* __restrict__ bias,
                         const bf16* __restrict__ g, const float* __restrict__ lse,
                         const float* __restrict__ delta, bf16* __restrict__ dq, int Lq,
                         int Lk, int heads, int d, float scale_log2, float scale) {
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* sQ = reinterpret_cast<bf16*>(smem);  // streamed slices
  bf16* sG = sQ + BQ * LWS;
  bf16* sK = sG + BQ * LWS;
  bf16* sV = sK + BK * LWS;
  bf16* sKc = sV + BK * LWS;                 // the key tile's chunk of k
  float* sB = reinterpret_cast<float*>(sKc + BK * LWC);

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int n_chunks = (d + WC - 1) / WC;
  const int q0 = blockIdx.x * BQ;
  const int h = blockIdx.y / n_chunks;
  const int v0 = (blockIdx.y % n_chunks) * WC;
  const int b = blockIdx.z;
  const int C = heads * d;
  const size_t head = (size_t)h * d;
  const bf16* qb = q + ((size_t)b * Lq + q0) * C + head;
  const bf16* gb = g + ((size_t)b * Lq + q0) * C + head;
  const bf16* kb = k + (size_t)b * Lk * C + head;
  const bf16* vb = v + (size_t)b * Lk * C + head;

  float row_lse[2], row_delta[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = q0 + 16 * warp + lane / 4 + 8 * r;
    const size_t at = ((size_t)b * heads + h) * Lq + row;
    row_lse[r] = row < Lq ? lse[at] * kLog2e : 0.f;
    row_delta[r] = row < Lq ? delta[at] : 0.f;
  }
  float dq_acc[WC / 8][4];
#pragma unroll
  for (int n = 0; n < WC / 8; ++n) dq_acc[n][0] = dq_acc[n][1] = dq_acc[n][2] = dq_acc[n][3] = 0.f;

  for (int k0 = 0; k0 < Lk; k0 += BK) {
    float p[8][4], ds[8][4];
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) p[j][e] = ds[j][e] = 0.f;
    // s = Q K^T and dp = G V^T over all d columns
    wide_pair(p, ds, sQ, sG, sK, sV, qb, gb, Lq - q0, kb + (size_t)k0 * C,
              vb + (size_t)k0 * C, Lk - k0, C, d, warp, lane);
    load_tile(sKc, LWC, kb + (size_t)k0 * C + v0, C, BK, WC, Lk - k0, d - v0);
    for (int c = threadIdx.x; c < BK; c += kThreads) {
      const int key = k0 + c;
      sB[c] = key >= Lk ? -INFINITY : (bias ? bias[(size_t)b * Lk + key] * kLog2e : 0.f);
    }
    __syncthreads();

#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        p[j][e] = exp2f(p[j][e] * scale_log2 + sB[8 * j + 2 * (lane % 4) + (e & 1)] -
                        row_lse[e >> 1]);
        ds[j][e] = p[j][e] * (ds[j][e] - row_delta[e >> 1]);
      }
    frag_by_tile<WC>(dq_acc, ds, sKc, lane);  // dQ[:, chunk] += dS K[:, chunk]
    __syncthreads();  // the readers of sKc/sB are done
  }

  store_rows<WC>(dq + (size_t)b * Lq * C + head + v0, C, dq_acc, q0 + 16 * warp, Lq, d - v0,
                 scale, lane);
}

size_t wide_dkv_bytes() {
  return sizeof(bf16) * (4 * 64 * LWS + 2 * BQ * LWC) + sizeof(float) * 2 * BQ;
}

size_t wide_dq_bytes() {
  return sizeof(bf16) * (4 * 64 * LWS + BK * LWC) + sizeof(float) * BK;
}

int launch_dkv_wide(const void* q, const void* k, const void* v, const void* bias,
                    const void* g, const void* lse, const void* delta, void* dk, void* dv,
                    int B, int Lq, int Lk, int heads, int d, cudaStream_t stream) {
  const size_t bytes = wide_dkv_bytes();
  cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_dkv_wide_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return (int)err;
  const float scale = 1.f / sqrtf((float)d);
  const dim3 grid((Lk + BK - 1) / BK, heads * ((d + WC - 1) / WC), B);
  flash_bwd_dkv_wide_kernel<<<grid, kThreads, bytes, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<const float*>(bias),
      static_cast<const bf16*>(g), static_cast<const float*>(lse),
      static_cast<const float*>(delta), static_cast<bf16*>(dk), static_cast<bf16*>(dv),
      Lq, Lk, heads, d, scale * kLog2e, scale);
  return (int)cudaGetLastError();
}

int launch_dq_wide(const void* q, const void* k, const void* v, const void* bias,
                   const void* g, const void* lse, const void* delta, void* dq, int B,
                   int Lq, int Lk, int heads, int d, cudaStream_t stream) {
  const size_t bytes = wide_dq_bytes();
  cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_dq_wide_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return (int)err;
  const float scale = 1.f / sqrtf((float)d);
  const dim3 grid((Lq + BQ - 1) / BQ, heads * ((d + WC - 1) / WC), B);
  flash_bwd_dq_wide_kernel<<<grid, kThreads, bytes, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<const float*>(bias),
      static_cast<const bf16*>(g), static_cast<const float*>(lse),
      static_cast<const float*>(delta), static_cast<bf16*>(dq), Lq, Lk, heads, d,
      scale * kLog2e, scale);
  return (int)cudaGetLastError();
}

template <int D>
size_t tile_bytes() {
  return sizeof(bf16) * (BQ + BK) * 2 * (D + 8) + sizeof(float) * 2 * BQ;
}

template <int D>
int launch_dkv(const void* q, const void* k, const void* v, const void* bias, const void* g,
               const void* lse, const void* delta, void* dk, void* dv, int B, int Lq,
               int Lk, int heads, int d, cudaStream_t stream) {
  const size_t bytes = tile_bytes<D>();
  auto kernel = flash_bwd_dkv_kernel<D>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return (int)err;
  const float scale = 1.f / sqrtf((float)d);
  const dim3 grid((Lk + BK - 1) / BK, heads, B);
  kernel<<<grid, kThreads, bytes, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<const float*>(bias),
      static_cast<const bf16*>(g), static_cast<const float*>(lse),
      static_cast<const float*>(delta), static_cast<bf16*>(dk), static_cast<bf16*>(dv),
      Lq, Lk, heads, d, scale * kLog2e, scale);
  return (int)cudaGetLastError();
}

template <int D>
int launch_dq(const void* q, const void* k, const void* v, const void* bias, const void* g,
              const void* lse, const void* delta, void* dq, int B, int Lq, int Lk,
              int heads, int d, cudaStream_t stream) {
  const size_t bytes = tile_bytes<D>();
  auto kernel = flash_bwd_dq_kernel<D>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return (int)err;
  const float scale = 1.f / sqrtf((float)d);
  const dim3 grid((Lq + BQ - 1) / BQ, heads, B);
  kernel<<<grid, kThreads, bytes, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<const float*>(bias),
      static_cast<const bf16*>(g), static_cast<const float*>(lse),
      static_cast<const float*>(delta), static_cast<bf16*>(dq), Lq, Lk, heads, d,
      scale * kLog2e, scale);
  return (int)cudaGetLastError();
}

}  // namespace

// Head widths the kernels take: d a multiple of 8 with d <= 80 (SD's UNet
// heads, d = 40 and 80, padded to 48 / 80) or d = 512 (the VAE's one head).
extern "C" int hv_flash_bwd_dkv(const void* q, const void* k, const void* v,
                                const void* bias, const void* g, const void* lse,
                                const void* delta, void* dk, void* dv, int B, int Lq,
                                int Lk, int heads, int d, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (d <= 0 || d % 8 != 0) return (int)cudaErrorInvalidValue;
  if (d <= 48)
    return launch_dkv<48>(q, k, v, bias, g, lse, delta, dk, dv, B, Lq, Lk, heads, d, s);
  if (d <= 80)
    return launch_dkv<80>(q, k, v, bias, g, lse, delta, dk, dv, B, Lq, Lk, heads, d, s);
  if (d == 512)
    return launch_dkv_wide(q, k, v, bias, g, lse, delta, dk, dv, B, Lq, Lk, heads, d, s);
  return (int)cudaErrorInvalidValue;
}

extern "C" int hv_flash_bwd_dq(const void* q, const void* k, const void* v,
                               const void* bias, const void* g, const void* lse,
                               const void* delta, void* dq, int B, int Lq, int Lk,
                               int heads, int d, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (d <= 0 || d % 8 != 0) return (int)cudaErrorInvalidValue;
  if (d <= 48) return launch_dq<48>(q, k, v, bias, g, lse, delta, dq, B, Lq, Lk, heads, d, s);
  if (d <= 80) return launch_dq<80>(q, k, v, bias, g, lse, delta, dq, B, Lq, Lk, heads, d, s);
  if (d == 512) return launch_dq_wide(q, k, v, bias, g, lse, delta, dq, B, Lq, Lk, heads, d, s);
  return (int)cudaErrorInvalidValue;
}

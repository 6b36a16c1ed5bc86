// Frame-axis (temporal) multi-head attention backward, bf16, for Hopper (sm_90a).
//
// Replaces: humanvid_tpu/ops/temporal_attention.py, the Pallas kernel
// `_bwd_kernel`, launched by `_call_bwd` through `_temporal_bwd`.
//
// Computes, for each (b, position l, head h), the gradient of
//   out = softmax_over_frames(q k^T * d^-1/2) v
// (the forward of csrc/temporal_attention.cu) given g = dL/dout, on
// q/k/v/g/dq/dk/dv of shape (b, f, l, c) with heads packed in c, f <= 32:
//   p  = softmax(q k^T * scale)            (recomputed, fp32)
//   dv = p^T g
//   dp = g v^T,  delta = rowsum(dp * p),  ds = p * (dp - delta)
//   dq = ds k * scale,  dk = ds^T q * scale
// with p and ds rounded to bf16 before their products, as the JAX kernel
// does. One pass, no residual beyond q, k and v.
//
// What bounds it on the H100: each position's f x f attention is tiny
// (five 24 x 24 x d products), so a call is a few GFLOP against the bytes
// of q, k, v, g, dq, dk and dv (7 x 110 MB at the stage-2 level-0 shape):
// device-memory bytes bound it. Reaching that bound needs many loads in
// flight; this version holds four 32-row tiles per warp in shared memory,
// which limits how many warps fit an SM (4 at d = 160, 8 at d = 40).
//
// The simple design, in kernel B's layout: a warp owns one (b, position,
// head); it stages that position's f rows of q, k, v and g (zero-padded to
// 32 rows and DP columns) in shared memory with 16-byte loads, computes
// the 32 x 32 logits and dp = g v^T with `mma.sync.m16n8k16` (bf16 in,
// fp32 accumulate), masks frames >= f, takes the softmax, delta and ds in
// registers (fp32), writes p and ds to shared memory as bf16, and forms
// dq, dk and dv in 64-column chunks from `ldmatrix` operands (`.trans`
// for p^T, ds^T and every right-hand tile). Padded query frames carry zero
// g, hence zero ds, and contribute nothing; padded key frames get p = 0
// and are not stored. A block holds 4 warps (4 positions of one head).

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

#include "warp_mma.cuh"

namespace {

constexpr int kMaxFrames = 32;
constexpr int kWarps = 4;
constexpr int LP = kMaxFrames + 8;  // row stride of the p / ds tiles (80 bytes)
constexpr float kLog2e = 1.4426950408889634f;

// out[32 x DP] = A[32 x 32] * B[32 x DP], stored as bf16 times `mul` to the
// rows < F and columns < d of dst (row stride frame_stride). A is read from
// the 32 x 32 shared tile sA, transposed when TRANS_A (sA holds A^T); B is
// a shared tile of 32 rows (row stride DP + 8).
template <int DP, bool TRANS_A>
__device__ __forceinline__ void product_store(const bf16* sA, const bf16* sB, bf16* dst,
                                              size_t frame_stride, int F, int d,
                                              float mul, int lane) {
  constexpr int LD = DP + 8;
  constexpr int kMaxTiles = 8;
#pragma unroll
  for (int n0 = 0; n0 < DP; n0 += 64) {
    float o[2][kMaxTiles][4];
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
      for (int n = 0; n < kMaxTiles; ++n)
        o[mt][n][0] = o[mt][n][1] = o[mt][n][2] = o[mt][n][3] = 0.f;
#pragma unroll
    for (int t = 0; t < 2; ++t) {
      uint32_t a[2][4];
#pragma unroll
      for (int mt = 0; mt < 2; ++mt) {
        if (TRANS_A) {
          ldmatrix_x4_trans(a[mt], sA + (16 * t + 8 * (lane / 16) + lane % 8) * LP + 16 * mt +
                                       8 * ((lane / 8) % 2));
        } else {
          ldmatrix_x4(a[mt], sA + (16 * mt + lane % 16) * LP + 16 * t + (lane / 16) * 8);
        }
      }
#pragma unroll
      for (int np = 0; np < kMaxTiles / 2; ++np) {
        if (n0 + 16 * np >= DP) break;
        uint32_t b[4];
        ldmatrix_x4_trans(b, sB + (t * 16 + (lane % 8) + ((lane / 8) % 2) * 8) * LD + n0 +
                                 np * 16 + (lane / 16) * 8);
#pragma unroll
        for (int mt = 0; mt < 2; ++mt) {
          mma_bf16(o[mt][2 * np], a[mt], b[0], b[1]);
          mma_bf16(o[mt][2 * np + 1], a[mt], b[2], b[3]);
        }
      }
    }
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
      for (int n = 0; n < kMaxTiles; ++n) {
        if (n0 + 8 * n >= DP) break;
        const int col = n0 + 8 * n + 2 * (lane % 4);
        if (col >= d) continue;
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const int row = 16 * mt + lane / 4 + 8 * r;
          if (row < F) {
            *reinterpret_cast<__nv_bfloat162*>(dst + row * frame_stride + col) =
                __floats2bfloat162_rn(o[mt][n][2 * r] * mul, o[mt][n][2 * r + 1] * mul);
          }
        }
      }
  }
}

// acc[32 x 32] = A[32 x DP] * B[32 x DP]^T for two shared tiles of 32 rows.
template <int DP>
__device__ __forceinline__ void rows_by_rows(float (&acc)[2][4][4], const bf16* sA,
                                             const bf16* sB, int lane) {
  constexpr int LD = DP + 8;
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[mt][j][0] = acc[mt][j][1] = acc[mt][j][2] = acc[mt][j][3] = 0.f;
#pragma unroll
  for (int kk = 0; kk < DP / 16; ++kk) {
    uint32_t a[2][4];
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
      ldmatrix_x4(a[mt], sA + (mt * 16 + lane % 16) * LD + kk * 16 + (lane / 16) * 8);
#pragma unroll
    for (int jp = 0; jp < 2; ++jp) {
      uint32_t b[4];
      ldmatrix_x4(b, sB + (jp * 16 + (lane % 8) + (lane / 16) * 8) * LD + kk * 16 +
                         ((lane / 8) % 2) * 8);
#pragma unroll
      for (int mt = 0; mt < 2; ++mt) {
        mma_bf16(acc[mt][2 * jp], a[mt], b[0], b[1]);
        mma_bf16(acc[mt][2 * jp + 1], a[mt], b[2], b[3]);
      }
    }
  }
}

template <int DP>
__global__ void __launch_bounds__(kWarps * 32)
temporal_bwd_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                    const bf16* __restrict__ v, const bf16* __restrict__ g,
                    bf16* __restrict__ dq, bf16* __restrict__ dk, bf16* __restrict__ dv,
                    int F, int L, int heads, int d, float scale_log2, float scale) {
  constexpr int LD = DP + 8;  // an odd multiple of 16 bytes: ldmatrix conflict-free
  constexpr int TILE = kMaxFrames * LD;
  extern __shared__ __align__(128) unsigned char smem[];
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  bf16* sQ = reinterpret_cast<bf16*>(smem) + warp * (4 * TILE + 2 * kMaxFrames * LP);
  bf16* sK = sQ + TILE;
  bf16* sV = sK + TILE;
  bf16* sG = sV + TILE;
  bf16* sP = sG + TILE;               // p, bf16, [query frame][key frame]
  bf16* sS = sP + kMaxFrames * LP;    // ds, bf16, [query frame][key frame]

  const int pos = blockIdx.x * kWarps + warp;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  if (pos >= L) return;  // only warp-level synchronisation below

  const int C = heads * d;
  const size_t frame_stride = (size_t)L * C;
  const size_t base = ((size_t)b * F * L + pos) * C + (size_t)h * d;

  for (int e = lane; e < kMaxFrames * (DP / 8); e += 32) {
    const int r = e / (DP / 8);
    const int c = (e % (DP / 8)) * 8;
    uint4 vq = make_uint4(0u, 0u, 0u, 0u), vk = vq, vv = vq, vg = vq;
    if (r < F && c < d) {
      const size_t off = base + r * frame_stride + c;
      vq = *reinterpret_cast<const uint4*>(q + off);
      vk = *reinterpret_cast<const uint4*>(k + off);
      vv = *reinterpret_cast<const uint4*>(v + off);
      vg = *reinterpret_cast<const uint4*>(g + off);
    }
    *reinterpret_cast<uint4*>(sQ + r * LD + c) = vq;
    *reinterpret_cast<uint4*>(sK + r * LD + c) = vk;
    *reinterpret_cast<uint4*>(sV + r * LD + c) = vv;
    *reinterpret_cast<uint4*>(sG + r * LD + c) = vg;
  }
  __syncwarp();

  // p = softmax(Q K^T * scale) over key frames < F; element e of tile
  // (mt, j) is key frame 8j + 2*(lane%4) + (e&1) of query frame
  // 16mt + lane/4 + 8*(e>>1)
  float p[2][4][4];
  rows_by_rows<DP>(p, sQ, sK, lane);
  float dp[2][4][4];
  rows_by_rows<DP>(dp, sG, sV, lane);  // dp = G V^T
#pragma unroll
  for (int mt = 0; mt < 2; ++mt) {
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int key = 8 * j + 2 * (lane % 4) + (e & 1);
        p[mt][j][e] = key < F ? p[mt][j][e] * scale_log2 : -INFINITY;
        mx[e >> 1] = fmaxf(mx[e >> 1], p[mt][j][e]);
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
    for (int j = 0; j < 4; ++j)
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
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int row = 16 * mt + lane / 4 + 8 * r;
        const int col = 8 * j + 2 * (lane % 4);
        const float p0 = p[mt][j][2 * r], p1 = p[mt][j][2 * r + 1];
        *reinterpret_cast<__nv_bfloat162*>(sP + row * LP + col) = __floats2bfloat162_rn(p0, p1);
        *reinterpret_cast<__nv_bfloat162*>(sS + row * LP + col) = __floats2bfloat162_rn(
            p0 * (dp[mt][j][2 * r] - delta[r]), p1 * (dp[mt][j][2 * r + 1] - delta[r]));
      }
  }
  __syncwarp();

  product_store<DP, false>(sS, sK, dq + base, frame_stride, F, d, scale, lane);  // ds k
  product_store<DP, true>(sS, sQ, dk + base, frame_stride, F, d, scale, lane);   // ds^T q
  product_store<DP, true>(sP, sG, dv + base, frame_stride, F, d, 1.f, lane);     // p^T g
}

template <int DP>
int launch(const void* q, const void* k, const void* v, const void* g, void* dq, void* dk,
           void* dv, int B, int F, int L, int heads, int d, cudaStream_t stream) {
  const size_t bytes =
      sizeof(bf16) * kWarps * (4 * kMaxFrames * (DP + 8) + 2 * kMaxFrames * LP);
  auto kernel = temporal_bwd_kernel<DP>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return (int)err;
  const float scale = 1.f / sqrtf((float)d);
  const dim3 grid((L + kWarps - 1) / kWarps, heads, B);
  kernel<<<grid, kWarps * 32, bytes, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<const bf16*>(g), static_cast<bf16*>(dq),
      static_cast<bf16*>(dk), static_cast<bf16*>(dv), F, L, heads, d, scale * kLog2e,
      scale);
  return (int)cudaGetLastError();
}

}  // namespace

// Head widths the kernel takes: d a multiple of 8, d <= 160 (the motion
// modules' d = 40/80/160, padded to 48 / 80 / 160).
extern "C" int hv_temporal_bwd(const void* q, const void* k, const void* v, const void* g,
                               void* dq, void* dk, void* dv, int B, int F, int L,
                               int heads, int d, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (F < 1 || F > kMaxFrames || d <= 0 || d % 8 != 0 || heads < 1)
    return (int)cudaErrorInvalidValue;
  if (d <= 48) return launch<48>(q, k, v, g, dq, dk, dv, B, F, L, heads, d, s);
  if (d <= 80) return launch<80>(q, k, v, g, dq, dk, dv, B, F, L, heads, d, s);
  if (d <= 160) return launch<160>(q, k, v, g, dq, dk, dv, B, F, L, heads, d, s);
  return (int)cudaErrorInvalidValue;
}

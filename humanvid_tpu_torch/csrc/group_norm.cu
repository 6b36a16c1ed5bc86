// GroupNorm(+SiLU) forward, bf16, for Hopper (sm_90a).
//
// Replaces: humanvid_tpu/ops/group_norm.py, the Pallas kernel `_stats_kernel`
// (per-channel fp32 [sum, sumsq] over row blocks), together with the folded
// apply of `_fused_fwd_impl` (:145-166) that follows it.
//
// Computes, on x of logical shape (N, C, H, W), stored channels_last (rows
// of C values: (N, H*W, C) in memory) or contiguous NCHW, with G groups of
// C/G adjacent channels: the mean and the biased variance of each (sample,
// group) over H*W*C/G values in fp32; a = rstd * gamma and
// b = beta - mean * a for each (n, c); y = act(x * a + b) in fp32, rounded
// once to bf16, in x's layout. act is the identity or SiLU, v * sigmoid(v).
//
// What bounds it on the H100: device-memory bytes. A call must read x once
// and write y once; the arithmetic is a few operations per byte. This design
// reads x twice (statistics, then apply), so its floor is 1.5x the bound.
// What it does about the bytes: every access to x and y is a 16-byte vector
// and a warp covers whole rows, so reads and writes are coalesced; a thread
// keeps 4 rows' loads in flight; the statistics pass writes only one
// (mean, M2) pair per (tile, channel), a few MB at the decode's largest
// shape against 805 MB of x.
//
// Kernels (one call launches three, on PyTorch's stream):
// 1. gn_stats_nhwc: blocks over (row tile, sample). Each thread owns 8
//    adjacent channels (one 16-byte vector of a row) and walks the tile's
//    rows P at a time, P row lanes side by side. It sums x - pivot and
//    (x - pivot)^2 per channel, the pivot being its first value of that
//    channel, so the variance keeps its digits when |mean| >> std (the TPU
//    kernel's one-pass E[x^2] - mean^2 loses them). The lanes' (count,
//    mean, M2) are merged by Chan's formula in shared memory and written
//    per (tile, channel) to a workspace the wrapper allocates.
// 2. gn_finalize: one block per (group, sample) merges the group's (tile,
//    channel) partials in a fixed order and writes a and b for its channels.
//    No float atomics anywhere: a run repeats bit for bit.
// 3. gn_apply_nhwc: the same tiles; each thread holds a and b of its 8
//    channels in registers and streams rows in and out.
// Contiguous NCHW (rare on the card, whose modules are channels_last; when
// H = W = 1 PyTorch reports both layouts and the channels_last kernels take
// it) has its own simple kernels: one warp per (channel, tile) with 2-byte
// loads for the statistics, an elementwise apply over 16-byte vectors.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

namespace {

typedef __nv_bfloat16 bf16;

constexpr int kUnroll = 4;          // rows in flight per thread
constexpr int kFinalizeThreads = 256;
constexpr int kNchwWarps = 8;

// Chan et al.'s merge of (count, mean, M2) with (nb, mb, qb).
__device__ __forceinline__ void merge(float& n, float& mean, float& m2, float nb, float mb,
                                      float qb) {
  if (nb == 0.f) return;
  if (n == 0.f) {
    n = nb;
    mean = mb;
    m2 = qb;
    return;
  }
  const float tot = n + nb;
  const float d = mb - mean;
  const float w = nb / tot;
  mean += d * w;
  m2 += qb + d * d * n * w;
  n = tot;
}

__device__ __forceinline__ void unpack8(const uint4& v, float* f) {
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&v);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 t = __bfloat1622float2(h[i]);
    f[2 * i] = t.x;
    f[2 * i + 1] = t.y;
  }
}

__device__ __forceinline__ uint4 pack8(const float* f) {
  uint4 v;
  __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&v);
#pragma unroll
  for (int i = 0; i < 4; ++i) h[i] = __floats2bfloat162_rn(f[2 * i], f[2 * i + 1]);
  return v;
}

__device__ __forceinline__ uint4 load16(const bf16* p) {
  return __ldg(reinterpret_cast<const uint4*>(p));
}

template <bool SILU>
__device__ __forceinline__ float act(float v) {
  if (SILU) return v * (1.f / (1.f + expf(-v)));
  return v;
}

// Rows of tile t that row lane p of P reads.
__device__ __forceinline__ float lane_rows(int rows, int p, int P) {
  return rows > p ? (float)((rows - p + P - 1) / P) : 0.f;
}

// grid (tiles, N); block V * P threads, V = C / 8; dynamic shared memory
// P * C float2. part: (N, tiles, C) of (mean, M2).
__global__ void gn_stats_nhwc(const bf16* __restrict__ x, float2* __restrict__ part, int HW,
                              int C, int T, int P) {
  extern __shared__ float2 lanes[];  // [P][C]
  const int V = C / 8;
  const int v = threadIdx.x % V;
  const int p = threadIdx.x / V;
  const int t = blockIdx.x, n = blockIdx.y;
  const int r0 = t * T;
  const int r1 = min(HW, r0 + T);
  const bf16* xs = x + (size_t)n * HW * C + v * 8;

  float piv[8], s1[8], s2[8];
#pragma unroll
  for (int j = 0; j < 8; ++j) piv[j] = s1[j] = s2[j] = 0.f;
  int r = r0 + p;
  if (r < r1) unpack8(load16(xs + (size_t)r * C), piv);
  for (; r + (kUnroll - 1) * P < r1; r += kUnroll * P) {
    uint4 buf[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) buf[u] = load16(xs + (size_t)(r + u * P) * C);
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      float f[8];
      unpack8(buf[u], f);
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const float d = f[j] - piv[j];
        s1[j] += d;
        s2[j] += d * d;
      }
    }
  }
  for (; r < r1; r += P) {
    float f[8];
    unpack8(load16(xs + (size_t)r * C), f);
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const float d = f[j] - piv[j];
      s1[j] += d;
      s2[j] += d * d;
    }
  }
  const float cnt = lane_rows(r1 - r0, p, P);
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    float2 m = make_float2(0.f, 0.f);
    if (cnt > 0.f) m = make_float2(piv[j] + s1[j] / cnt, fmaxf(s2[j] - s1[j] * s1[j] / cnt, 0.f));
    lanes[p * C + v * 8 + j] = m;
  }
  __syncthreads();
  // one thread per channel merges the P lanes in order
  for (int c = threadIdx.x; c < C; c += blockDim.x) {
    float n_ = 0.f, mean = 0.f, m2 = 0.f;
    for (int q = 0; q < P; ++q) {
      const float2 m = lanes[q * C + c];
      merge(n_, mean, m2, lane_rows(r1 - r0, q, P), m.x, m.y);
    }
    part[((size_t)n * gridDim.x + t) * C + c] = make_float2(mean, m2);
  }
}

// grid (tiles, N); block kNchwWarps warps; warp w takes channels w, w + 8, ...
__global__ void gn_stats_nchw(const bf16* __restrict__ x, float2* __restrict__ part, int HW,
                              int C, int T) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int t = blockIdx.x, n = blockIdx.y;
  const int r0 = t * T;
  const int r1 = min(HW, r0 + T);
  for (int c = warp; c < C; c += kNchwWarps) {
    const bf16* row = x + ((size_t)n * C + c) * HW;
    const float piv = r0 + lane < r1 ? __bfloat162float(row[r0 + lane]) : 0.f;
    float s1 = 0.f, s2 = 0.f;
    for (int r = r0 + lane; r < r1; r += 32) {
      const float d = __bfloat162float(row[r]) - piv;
      s1 += d;
      s2 += d * d;
    }
    float cnt = lane_rows(r1 - r0, lane, 32);
    float mean = 0.f, m2 = 0.f;
    if (cnt > 0.f) {
      mean = piv + s1 / cnt;
      m2 = fmaxf(s2 - s1 * s1 / cnt, 0.f);
    }
    // a fixed butterfly: lane 0's result is the same on every run
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
      const float nb = __shfl_xor_sync(0xffffffffu, cnt, o);
      const float mb = __shfl_xor_sync(0xffffffffu, mean, o);
      const float qb = __shfl_xor_sync(0xffffffffu, m2, o);
      merge(cnt, mean, m2, nb, mb, qb);
    }
    if (lane == 0) part[((size_t)n * gridDim.x + t) * C + c] = make_float2(mean, m2);
  }
}

// grid (G, N); block kFinalizeThreads. ab: (N, C) of (a, b).
__global__ void __launch_bounds__(kFinalizeThreads)
gn_finalize(const float2* __restrict__ part, const void* __restrict__ gamma,
            const void* __restrict__ beta, int affine_bf16, float2* __restrict__ ab, int HW,
            int C, int G, int T, int tiles, float eps) {
  __shared__ float sn[kFinalizeThreads], sm[kFinalizeThreads], sq[kFinalizeThreads];
  __shared__ float stat[2];
  const int cg = C / G;
  const int g = blockIdx.x, n = blockIdx.y;
  const int tid = threadIdx.x;
  float cnt = 0.f, mean = 0.f, m2 = 0.f;
  for (int k = tid; k < tiles * cg; k += kFinalizeThreads) {
    const int t = k / cg, j = k % cg;
    const float2 m = part[((size_t)n * tiles + t) * C + g * cg + j];
    merge(cnt, mean, m2, (float)min(T, HW - t * T), m.x, m.y);
  }
  sn[tid] = cnt;
  sm[tid] = mean;
  sq[tid] = m2;
  __syncthreads();
  for (int s = kFinalizeThreads / 2; s > 0; s >>= 1) {
    if (tid < s) {
      merge(cnt, mean, m2, sn[tid + s], sm[tid + s], sq[tid + s]);
      sn[tid] = cnt;
      sm[tid] = mean;
      sq[tid] = m2;
    }
    __syncthreads();
  }
  if (tid == 0) {
    stat[0] = mean;
    stat[1] = 1.f / sqrtf(m2 / cnt + eps);
  }
  __syncthreads();
  for (int j = tid; j < cg; j += kFinalizeThreads) {
    const int c = g * cg + j;
    float gm, bt;
    if (affine_bf16) {
      gm = __bfloat162float(static_cast<const bf16*>(gamma)[c]);
      bt = __bfloat162float(static_cast<const bf16*>(beta)[c]);
    } else {
      gm = static_cast<const float*>(gamma)[c];
      bt = static_cast<const float*>(beta)[c];
    }
    const float a = stat[1] * gm;
    ab[(size_t)n * C + c] = make_float2(a, bt - stat[0] * a);
  }
}

// grid (tiles, N); block V * P threads, as gn_stats_nhwc.
template <bool SILU>
__global__ void gn_apply_nhwc(const bf16* __restrict__ x, const float2* __restrict__ ab,
                              bf16* __restrict__ y, int HW, int C, int T, int P) {
  const int V = C / 8;
  const int v = threadIdx.x % V;
  const int p = threadIdx.x / V;
  const int t = blockIdx.x, n = blockIdx.y;
  const int r0 = t * T;
  const int r1 = min(HW, r0 + T);
  float a[8], b[8];
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const float2 q = ab[(size_t)n * C + v * 8 + j];
    a[j] = q.x;
    b[j] = q.y;
  }
  const size_t base = (size_t)n * HW * C + v * 8;
  int r = r0 + p;
  for (; r + (kUnroll - 1) * P < r1; r += kUnroll * P) {
    uint4 buf[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) buf[u] = load16(x + base + (size_t)(r + u * P) * C);
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      float f[8];
      unpack8(buf[u], f);
#pragma unroll
      for (int j = 0; j < 8; ++j) f[j] = act<SILU>(f[j] * a[j] + b[j]);
      *reinterpret_cast<uint4*>(y + base + (size_t)(r + u * P) * C) = pack8(f);
    }
  }
  for (; r < r1; r += P) {
    float f[8];
    unpack8(load16(x + base + (size_t)r * C), f);
#pragma unroll
    for (int j = 0; j < 8; ++j) f[j] = act<SILU>(f[j] * a[j] + b[j]);
    *reinterpret_cast<uint4*>(y + base + (size_t)r * C) = pack8(f);
  }
}

// Contiguous NCHW: element e lies in channel row e / HW (= n * C + c), so a
// 16-byte vector may straddle two rows when HW % 8 != 0.
template <bool SILU>
__global__ void gn_apply_nchw(const bf16* __restrict__ x, const float2* __restrict__ ab,
                              bf16* __restrict__ y, size_t nvec, int HW) {
  for (size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x; i < nvec;
       i += (size_t)gridDim.x * blockDim.x) {
    const size_t e = i * 8;
    size_t row = e / HW;
    int rem = (int)(e - row * HW);
    float f[8];
    unpack8(load16(x + e), f);
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      if (rem == HW) {
        rem = 0;
        ++row;
      }
      const float2 q = __ldg(ab + row);
      f[j] = act<SILU>(f[j] * q.x + q.y);
      ++rem;
    }
    *reinterpret_cast<uint4*>(y + e) = pack8(f);
  }
}

}  // namespace

// y = act(GroupNorm(x)) for bf16 x of logical shape (N, C, H*W).
// part: N * tiles * C float2 of scratch; ab: N * C float2 of scratch.
// channels_last = 1: rows of C values, tiles of T rows, P row lanes per
// block (the wrapper picks T and P); 0: contiguous NCHW, P unused.
extern "C" int hv_group_norm_fwd(const void* x, const void* gamma, const void* beta, void* y,
                                 void* part, void* ab, int N, int C, int HW, int G,
                                 int channels_last, int affine_bf16, int silu, int tiles,
                                 int T, int P, float eps, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (N < 1 || N > 65535 || C < 8 || C % 8 != 0 || C > 4096 || HW < 1 || G < 1 ||
      C % G != 0 || tiles < 1 || tiles > 65535 || T < 1 || (size_t)tiles * T < (size_t)HW ||
      (size_t)(tiles - 1) * T >= (size_t)HW)
    return (int)cudaErrorInvalidValue;
  const bf16* xb = static_cast<const bf16*>(x);
  bf16* yb = static_cast<bf16*>(y);
  float2* pt = static_cast<float2*>(part);
  float2* abp = static_cast<float2*>(ab);
  const dim3 grid(tiles, N);
  cudaError_t err;
  if (channels_last) {
    const int threads = (C / 8) * P;
    if (P < 1 || threads > 1024) return (int)cudaErrorInvalidValue;
    gn_stats_nhwc<<<grid, threads, sizeof(float2) * P * C, s>>>(xb, pt, HW, C, T, P);
  } else {
    gn_stats_nchw<<<grid, kNchwWarps * 32, 0, s>>>(xb, pt, HW, C, T);
  }
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  gn_finalize<<<dim3(G, N), kFinalizeThreads, 0, s>>>(pt, gamma, beta, affine_bf16, abp, HW, C,
                                                      G, T, tiles, eps);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  if (channels_last) {
    const int threads = (C / 8) * P;
    if (silu)
      gn_apply_nhwc<true><<<grid, threads, 0, s>>>(xb, abp, yb, HW, C, T, P);
    else
      gn_apply_nhwc<false><<<grid, threads, 0, s>>>(xb, abp, yb, HW, C, T, P);
  } else {
    const size_t nvec = (size_t)N * C * HW / 8;
    const size_t want = (nvec + 255) / 256;
    const int blocks = (int)(want < 132 * 16 ? want : 132 * 16);
    if (silu)
      gn_apply_nchw<true><<<blocks, 256, 0, s>>>(xb, abp, yb, nvec, HW);
    else
      gn_apply_nchw<false><<<blocks, 256, 0, s>>>(xb, abp, yb, nvec, HW);
  }
  return (int)cudaGetLastError();
}

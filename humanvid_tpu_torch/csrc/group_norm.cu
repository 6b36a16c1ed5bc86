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
// and write y once; the arithmetic is a few operations per byte. Statistics
// and apply need x twice, so a design that reads x from device memory for
// each (the first design: three launches) has a floor of 1.5x the bound,
// and at the UNet's small shapes its launches and finalize dominate.
//
// What this design does about it, for channels_last x at the UNet's shapes
// (one launch, x read from device memory once):
// gn_cluster_nhwc. A thread-block cluster of K <= 16 blocks owns a slab of
// S channels (a whole number of groups, a multiple of 8, at most 256) of one
// sample; block `rank` owns rows [rank*T, rank*T + T). Its thread 0 issues
// TMA loads of the first `resident` of its rows at once, in chunks of R rows
// (3-D map (C, HW, N), boxes S x R, so a box never reaches the next sample;
// each chunk on its own mbarrier), into shared memory, where they stay; the
// rest of its rows it reads with 16-byte loads. Each thread owns 8 adjacent
// channels (one 16-byte vector of a row) and walks the rows P at a time as
// the chunks land, summing x - pivot and (x - pivot)^2 per channel (the
// pivot its first value of the channel, so the variance keeps its digits
// when |mean| >> std). The P row lanes' (count, mean, M2) are merged in a
// fixed order, the mean first (from the lanes' offsets to the first lane's
// mean), then M2 with each lane's n * (mean_lane - mean)^2: no division in
// the chain. The cluster's blocks exchange these per-channel partials over
// distributed shared memory (`mapa` + `ld.shared::cluster` between
// `barrier.cluster` arrive/wait); every block merges the K partials in rank
// order and the channels of each group in channel order (a warp a group,
// a fixed shuffle tree), so all blocks hold the same a and b and a launch
// repeats bit for bit (no float atomics anywhere). Each block then applies
// a and b (+ SiLU, by ex2.approx and rcp.approx) to the rows it did not
// hold straight after the cluster barrier, reading them again from L2, and
// to its held rows in shared memory, in place, which it writes back by TMA
// store. Measured on the H100 (PERF.md section 6): blocks that hold all
// their rows in 61-123 KB, one or two an SM, spend each item in a chain of
// dependent phases (load, merge, exchange, apply, store) that the SM cannot
// hide; so the size rule (`ops/group_norm.py:cluster_plan`) gives a block
// at most 32 KB of rows and lets it re-read up to 3 times as many from L2,
// and the registers are held to 3 blocks an SM, which hides more of it.
// A cluster's working set is a few MB (UNet level 0: 1.97 MB), so the
// re-read rows are still in L2. On the host a launch encodes the two maps
// and launches by cudaLaunchKernelEx; the function's attributes and the
// clusters the card holds at once (none: the launch is refused, and the
// wrapper raises) are asked of the runtime once per plan and kept
// (`HostCache`).
//
// The decode's shapes (a sample is 25-100 MB at 192x128 and above) fit no
// cluster: there the rule takes the two-pass design, three launches:
// 1. gn_stats_nhwc: blocks over (row tile, sample), each thread 8 channels
//    of P row lanes, pivot-shifted sums, lanes merged by Chan's formula and
//    written per (tile, channel) to a workspace the wrapper allocates;
// 2. gn_finalize: one block per (group, sample) merges the partials in a
//    fixed order and writes a and b;
// 3. gn_apply_nhwc: the same tiles stream x in and y out with a and b of
//    8 channels in registers; 16-byte vectors, 4 rows in flight a thread.
// Contiguous NCHW (rare on the card, whose modules are channels_last; when
// H = W = 1 PyTorch reports both layouts and the channels_last kernels take
// it) keeps its simple kernels: one warp per (channel, tile) with 2-byte
// loads for the statistics, an elementwise apply over 16-byte vectors.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

using namespace hopper;

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

// SiLU on the SFU: exp by ex2.approx, the quotient by rcp.approx (relative
// error ~1e-7, far under the bf16 rounding of the result); v -> -inf gives
// -0, as v * sigmoid(v) does.
template <bool SILU>
__device__ __forceinline__ float act(float v) {
  if (SILU) return __fdividef(v, 1.f + __expf(-v));
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

// ---- the one-pass cluster kernel -------------------------------------------

constexpr int kClusterThreads = 256;
constexpr int kMaxChunks = 32;  // mbarriers: chunks a block holds
constexpr int kMaxGroups = 32;  // groups in a slab
constexpr int kMaxCluster = 16;
constexpr int kMaxLanes = kClusterThreads;  // row lanes (at S = 8)
constexpr int kMinBlocks = 3;  // blocks an SM the registers must allow
constexpr int kClusterUnroll = 4;  // rows in flight a thread when it reads from L2 or device memory

// Shared memory of gn_cluster_nhwc, in this order from a 128-byte boundary:
// the held rows (resident x S bf16), the lanes' partials (P x S float2), the
// block's partial (S float2, read by the cluster), the channels' statistics
// (S float2), gamma and beta (S float2), the groups' (mean, rstd), the
// lanes' row counts and the chunks' mbarriers.
__host__ __device__ inline size_t cluster_smem(int S, int resident) {
  const int P = kClusterThreads / (S / 8);
  return 128 + (size_t)resident * S * 2 + (size_t)P * S * 8 + 3 * (size_t)S * 8 +
         kMaxGroups * 8 + kMaxLanes * 4 + kMaxChunks * 8;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;  // every lane holds the same sum, taken in a fixed order
}

// grid (K * C / S, N), clusters of K along x; block kClusterThreads.
template <bool SILU>
__global__ void __launch_bounds__(kClusterThreads, kMinBlocks)
gn_cluster_nhwc(const __grid_constant__ CUtensorMap x_map, const __grid_constant__ CUtensorMap y_map,
                const bf16* __restrict__ x, bf16* __restrict__ y, const void* __restrict__ gamma,
                const void* __restrict__ beta, int affine_bf16, int HW, int C, int cg, int S,
                int K, int T, int R, int resident, float eps) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 127) & ~static_cast<uintptr_t>(127));
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int V = S / 8, P = kClusterThreads / V;
  const int v = tid % V, p = tid / V;
  const bool active = p < P;
  const uint32_t rank = cluster_ctarank();
  const int c0 = (blockIdx.x / K) * S;
  const int n = blockIdx.y;
  const int r0 = (int)rank * T;
  const int rows = max(0, min(T, HW - r0));
  const int held = min(rows, resident);
  const int nchunks = (held + R - 1) / R;

  bf16* data = reinterpret_cast<bf16*>(smem);
  float2* lanes = reinterpret_cast<float2*>(smem + (size_t)resident * S * 2);
  float2* part = lanes + P * S;
  float2* chs = part + S;
  float2* gb = chs + S;
  float2* gst = gb + S;
  float* cnt = reinterpret_cast<float*>(gst + kMaxGroups);
  uint64_t* bars = reinterpret_cast<uint64_t*>(cnt + kMaxLanes);

  if (tid == 0) {
    for (int j = 0; j < nchunks; ++j) mbar_init(&bars[j], 1);
    fence_barrier_init();
  }
  if (tid < P) cnt[tid] = lane_rows(rows, tid, P);
  __syncthreads();
  if (tid == 0) {
    for (int j = 0; j < nchunks; ++j) {
      mbar_arrive_expect_tx(&bars[j], (uint32_t)R * S * 2);
      tma_load_3d(data + (size_t)j * R * S, &x_map, &bars[j], c0, r0 + j * R, n);
    }
  }
  // gamma and beta of the slab, read while the rows land
  for (int c = tid; c < S; c += kClusterThreads) {
    if (affine_bf16)
      gb[c] = make_float2(__bfloat162float(static_cast<const bf16*>(gamma)[c0 + c]),
                          __bfloat162float(static_cast<const bf16*>(beta)[c0 + c]));
    else
      gb[c] = make_float2(static_cast<const float*>(gamma)[c0 + c],
                          static_cast<const float*>(beta)[c0 + c]);
  }

  // statistics: lane p takes rows p, p + P, ... of the block's rows, the
  // held ones from shared memory as their chunks land, the rest from device
  // memory
  const size_t gbase = ((size_t)n * HW + r0) * C + c0 + v * 8;
  float piv[8], s1[8], s2[8];
#pragma unroll
  for (int e = 0; e < 8; ++e) piv[e] = s1[e] = s2[e] = 0.f;
  if (active && p < rows) {
    if (p < held) {
      mbar_wait(&bars[p / R], 0);
      unpack8(*reinterpret_cast<const uint4*>(data + (size_t)p * S + v * 8), piv);
    } else {
      unpack8(load16(x + gbase + (size_t)p * C), piv);
    }
  }
  if (active) {
    int r = p;
    for (int j = 0; j < nchunks; ++j) {
      const int r1 = min(held, (j + 1) * R);
      if (r < r1) mbar_wait(&bars[j], 0);
#pragma unroll 4
      for (; r < r1; r += P) {
        float f[8];
        unpack8(*reinterpret_cast<const uint4*>(data + (size_t)r * S + v * 8), f);
#pragma unroll
        for (int e = 0; e < 8; ++e) {
          const float dd = f[e] - piv[e];
          s1[e] += dd;
          s2[e] += dd * dd;
        }
      }
    }
    for (; r + (kClusterUnroll - 1) * P < rows; r += kClusterUnroll * P) {
      uint4 vec[kClusterUnroll];
#pragma unroll
      for (int u = 0; u < kClusterUnroll; ++u) vec[u] = load16(x + gbase + (size_t)(r + u * P) * C);
#pragma unroll
      for (int u = 0; u < kClusterUnroll; ++u) {
        float f[8];
        unpack8(vec[u], f);
#pragma unroll
        for (int e = 0; e < 8; ++e) {
          const float dd = f[e] - piv[e];
          s1[e] += dd;
          s2[e] += dd * dd;
        }
      }
    }
    for (; r < rows; r += P) {
      float f[8];
      unpack8(load16(x + gbase + (size_t)r * C), f);
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        const float dd = f[e] - piv[e];
        s1[e] += dd;
        s2[e] += dd * dd;
      }
    }
    const float nl = cnt[p];
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      float2 m = make_float2(0.f, 0.f);
      if (nl > 0.f) m = make_float2(piv[e] + s1[e] / nl, fmaxf(s2[e] - s1[e] * s1[e] / nl, 0.f));
      lanes[p * S + v * 8 + e] = m;
    }
  }
  __syncthreads();
  // the block's partial: one thread per channel merges the P lanes in
  // order, the mean first (offsets from lane 0's), then M2
  for (int c = tid; c < S; c += kClusterThreads) {
    float2 m = make_float2(0.f, 0.f);
    if (rows > 0) {
      const float ref = lanes[c].x;  // lane 0 holds a row whenever the block does
      float sd = 0.f;
#pragma unroll 4
      for (int l = 0; l < P; ++l) sd += cnt[l] * (lanes[l * S + c].x - ref);
      m.x = ref + sd / (float)rows;
#pragma unroll 4
      for (int l = 0; l < P; ++l) {
        const float2 t = lanes[l * S + c];
        const float dd = t.x - m.x;
        m.y += t.y + cnt[l] * dd * dd;
      }
    }
    part[c] = m;
  }
  // exchange: every block merges the cluster's partials in rank order (the
  // first block always holds rows)
  cluster_arrive();
  cluster_wait();
  for (int c = tid; c < S; c += kClusterThreads) {
    float2 rp[kMaxCluster];
#pragma unroll
    for (int k = 0; k < kMaxCluster; ++k)
      if (k < K) rp[k] = ld_dsmem_f2(dsmem_addr(&part[c], (uint32_t)k));
    float sd = 0.f, m2 = 0.f;
#pragma unroll
    for (int k = 0; k < kMaxCluster; ++k)
      if (k < K) sd += (float)max(0, min(T, HW - k * T)) * (rp[k].x - rp[0].x);
    const float mean = rp[0].x + sd / (float)HW;
#pragma unroll
    for (int k = 0; k < kMaxCluster; ++k) {
      if (k < K) {
        const float dd = rp[k].x - mean;
        m2 += rp[k].y + (float)max(0, min(T, HW - k * T)) * dd * dd;
      }
    }
    chs[c] = make_float2(mean, m2);
  }
  cluster_arrive();  // this block reads no other block's memory any more
  __syncthreads();
  // each group over its channels (every channel counts HW rows), a warp a
  // group
  for (int g = warp; g < S / cg; g += kClusterThreads / 32) {
    const float2* ch = chs + g * cg;
    const float ref = ch[0].x;
    float sd = 0.f, m2 = 0.f;
    for (int j = lane; j < cg; j += 32) sd += ch[j].x - ref;
    const float mean = ref + warp_sum(sd) / (float)cg;
    for (int j = lane; j < cg; j += 32) {
      const float dd = ch[j].x - mean;
      m2 += ch[j].y + (float)HW * dd * dd;
    }
    m2 = warp_sum(m2);
    if (lane == 0) gst[g] = make_float2(mean, 1.f / sqrtf(m2 / ((float)HW * cg) + eps));
  }
  __syncthreads();

  // apply: a = rstd * gamma, b = beta - mean * a; the rows past the held
  // ones first (still in L2), straight to device memory; then the held
  // rows in place, stored by TMA chunk by chunk
  float a[8], b[8];
#pragma unroll
  for (int e = 0; e < 8; ++e) {
    const int c = min(v, V - 1) * 8 + e;
    const float2 st = gst[c / cg], w = gb[c];
    a[e] = st.y * w.x;
    b[e] = w.y - st.x * a[e];
  }
  if (active) {
    int r = held + ((p - held % P) + P) % P;
    for (; r + (kClusterUnroll - 1) * P < rows; r += kClusterUnroll * P) {
      uint4 vec[kClusterUnroll];
#pragma unroll
      for (int u = 0; u < kClusterUnroll; ++u) vec[u] = load16(x + gbase + (size_t)(r + u * P) * C);
#pragma unroll
      for (int u = 0; u < kClusterUnroll; ++u) {
        float f[8];
        unpack8(vec[u], f);
#pragma unroll
        for (int e = 0; e < 8; ++e) f[e] = act<SILU>(f[e] * a[e] + b[e]);
        *reinterpret_cast<uint4*>(y + gbase + (size_t)(r + u * P) * C) = pack8(f);
      }
    }
    for (; r < rows; r += P) {
      float f[8];
      unpack8(load16(x + gbase + (size_t)r * C), f);
#pragma unroll
      for (int e = 0; e < 8; ++e) f[e] = act<SILU>(f[e] * a[e] + b[e]);
      *reinterpret_cast<uint4*>(y + gbase + (size_t)r * C) = pack8(f);
    }
#pragma unroll 4
    for (r = p; r < held; r += P) {
      uint4* row = reinterpret_cast<uint4*>(data + (size_t)r * S + v * 8);
      float f[8];
      unpack8(*row, f);
#pragma unroll
      for (int e = 0; e < 8; ++e) f[e] = act<SILU>(f[e] * a[e] + b[e]);
      *row = pack8(f);
    }
  }
  fence_proxy_async();
  __syncthreads();
  if (tid == 0) {
    for (int j = 0; j < nchunks; ++j)
      tma_store_3d(&y_map, data + (size_t)j * R * S, c0, r0 + j * R, n);
    bulk_commit();
    bulk_wait<0, true>();  // the stores have read shared memory
  }
  __syncwarp();  // the warp converged at the aligned cluster barrier
  cluster_wait();  // no block leaves while another may still read its partial
}

HostCache host_cache;

template <bool SILU>
int launch_cluster(const void* x, const void* gamma, const void* beta, void* y, int N, int C,
                   int HW, int G, int S, int K, int T, int R, int resident, int affine_bf16,
                   float eps, cudaStream_t s) {
  CUtensorMap maps[2];
  int err = make_map(&maps[0], x, C, HW, N, S, R, CU_TENSOR_MAP_SWIZZLE_NONE);
  if (!err) err = make_map(&maps[1], y, C, HW, N, S, R, CU_TENSOR_MAP_SWIZZLE_NONE);
  if (err) return err;
  const int smem = (int)cluster_smem(S, resident);
  auto kernel = gn_cluster_nhwc<SILU>;
  const void* fn = reinterpret_cast<const void*>(kernel);
  cudaError_t e = host_cache.reserve_smem(fn, smem);
  int set = 0;
  if (e == cudaSuccess && K > 8)
    e = host_cache.get(fn, -1, 0, &set, [&](int* v) {
      *v = 1;
      return cudaFuncSetAttribute(kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    });
  if (e != cudaSuccess) return (int)e;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(K * (C / S), N, 1);
  cfg.blockDim = dim3(kClusterThreads, 1, 1);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = s;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = K;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  // a cluster that no GPC can hold would fail at launch: refuse it here
  int clusters = 0;
  e = host_cache.get(fn, K, smem, &clusters,
                     [&](int* v) { return cudaOccupancyMaxActiveClusters(v, kernel, &cfg); });
  if (e != cudaSuccess) return (int)e;
  if (clusters < 1) return (int)cudaErrorInvalidConfiguration;
  e = cudaLaunchKernelEx(&cfg, kernel, maps[0], maps[1], static_cast<const bf16*>(x),
                         static_cast<bf16*>(y), gamma, beta, affine_bf16, HW, C, C / G, S, K, T,
                         R, resident, eps);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

}  // namespace

// The two-pass design: y = act(GroupNorm(x)) for bf16 x of logical shape
// (N, C, H*W). part: N * tiles * C float2 of scratch; ab: N * C float2 of scratch.
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

// The one-pass design: y = act(GroupNorm(x)) for channels_last bf16 x of
// logical shape (N, C, H*W), clusters of K blocks over slabs of S channels,
// T rows a block in chunks of R, `resident` of them held in shared memory
// (the wrapper's `cluster_plan`).
extern "C" int hv_group_norm_cluster(const void* x, const void* gamma, const void* beta, void* y,
                                     int N, int C, int HW, int G, int S, int K, int T, int R,
                                     int resident, int affine_bf16, int silu, float eps,
                                     void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (N < 1 || N > 65535 || C < 8 || C % 8 != 0 || HW < 1 || G < 1 || C % G != 0 || S < 8 ||
      S > 256 || S % 8 != 0 || C % S != 0 || S % (C / G) != 0 || S / (C / G) > kMaxGroups ||
      !(K == 1 || K == 2 || K == 4 || K == 8 || K == kMaxCluster) || R < 8 || R > 256 || R % 8 != 0 ||
      T < R || T % R != 0 || (size_t)K * T < (size_t)HW || resident < R || resident % R != 0 ||
      resident > T || resident / R > kMaxChunks || kClusterThreads / (S / 8) > kMaxLanes ||
      cluster_smem(S, resident) > 232448)
    return (int)cudaErrorInvalidValue;
  if (silu)
    return launch_cluster<true>(x, gamma, beta, y, N, C, HW, G, S, K, T, R, resident,
                                affine_bf16, eps, s);
  return launch_cluster<false>(x, gamma, beta, y, N, C, HW, G, S, K, T, R, resident, affine_bf16,
                               eps, s);
}

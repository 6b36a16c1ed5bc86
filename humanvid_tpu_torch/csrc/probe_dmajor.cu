// Orientation probe: which way round should a narrow head (d = 40) enter the
// tensor-core product? For Hopper (sm_90a).
//
// Replaces: tools/microbench.py, `probe_dmajor`'s Pallas kernels (`run`'s
// `pallas_call` with the arms `qk_lanes`, `qk_sublanes`, `pv_lanes` and
// `pv_dmajor`), one (lq x lk x d) product per grid step, of which only a
// 128-wide slice is stored so that device-memory traffic cannot hide the
// product's cost. The arms, per problem g of G (bf16 in, fp32 accumulate,
// bf16 out):
//   0 qk_lanes    q (lq, d), k (lk, d)        -> (q k^T)[:, :128]   (lq, 128)
//   1 qk_sublanes q (d, lq), k (d, lk), d-major -> the same product
//   2 pv_lanes    p (lq, lk), v (lk, d)       -> p v, zero-padded   (lq, 128)
//   3 pv_dmajor   v (d, lk), p (lq, lk)       -> v p^T              (d, lq)
// and the control is arm 0 at d = 128.
//
// What the arms ask on this card: with `mma.sync.m16n8k16` the contracted
// axis comes in steps of 16 and the output in tiles of 16 rows by 8
// columns. d = 40 as the contracted axis (QK) pads to 48 (1.2x) in either
// layout; the d-major layout only changes how the operands are read
// (`ldmatrix.trans`). As the PV output's columns (pv_lanes) it fits
// exactly in five n8 tiles; as the output's rows (pv_dmajor) it pads to 48.
//
// What bounds it on the H100: the QK arms, operations (2 * G * lq * lk * d:
// 10.7 GFLOP at G = 64, 1024 x 2048, d = 40, 10.9 us at 989 TFLOP/s; their
// 15.7 MB of inputs stay in the 50 MB L2 cache between timed calls). The PV
// arms, bytes: reading p (G * lq * lk * 2 = 268 MB, 80 us at 3.35 TB/s),
// so they measure memory, not the tensor cores.
//
// Design: one block of 4 warps per (64-row tile of the output, problem);
// it computes the whole product of its rows, looping over 64-wide tiles of
// lk, with tiles staged in shared memory by 16-byte loads. The QK arms store
// only the tiles inside the first 128 columns; so that the compiler keeps
// the products of the other tiles, every value of those is summed into a
// register that is stored only through `sink`, a pointer the wrapper never
// sets. d is zero-padded in shared memory where it is a contracted or an
// output-row axis.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include "warp_mma.cuh"

namespace {

constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int T = 64;        // rows of a block, keys of a tile
constexpr int LT = T + 8;    // shared row stride of a 64-wide tile (odd x 16 bytes)
constexpr int DN = 48;       // the narrow head padded to a multiple of 16
constexpr int STORED = 128;  // stored columns of the QK and pv_lanes outputs

__device__ __forceinline__ void ldmatrix_x2_trans(uint32_t (&r)[2], const bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0, %1}, [%2];\n"
               : "=r"(r[0]), "=r"(r[1])
               : "r"(smem_addr(p)));
}

// Copy `rows` rows of `cols` columns (multiples of 8) from `src` (row
// stride `ld`) into shared memory (row stride `lds`); rows >= valid_rows
// and columns >= valid_cols are zero.
__device__ __forceinline__ void load_tile(bf16* dst, int lds, const bf16* src, long long ld,
                                          int rows, int cols, int valid_rows, int valid_cols) {
  const int vecs = cols / 8;
  for (int e = threadIdx.x; e < rows * vecs; e += kThreads) {
    const int r = e / vecs;
    const int c = (e % vecs) * 8;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (r < valid_rows && c < valid_cols) {
      val = *reinterpret_cast<const uint4*>(src + r * ld + c);
    }
    *reinterpret_cast<uint4*>(dst + r * lds + c) = val;
  }
}

// Arms 0 and 1: S = Q K^T, DP the padded d. DMAJOR: q and k are (d, l).
template <int DP, bool DMAJOR>
__global__ void __launch_bounds__(kThreads)
probe_qk_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k, bf16* __restrict__ out,
                float* __restrict__ sink, int lq, int lk, int d) {
  constexpr int LD = DMAJOR ? LT : DP + 8;
  constexpr int QROWS = DMAJOR ? DP : T;  // shared tile rows
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* sQ = reinterpret_cast<bf16*>(smem);
  bf16* sK = sQ + QROWS * LD;

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int q0 = blockIdx.x * T;
  const int g = blockIdx.y;
  const bf16* qg = q + (size_t)g * lq * d;
  const bf16* kg = k + (size_t)g * lk * d;
  if (DMAJOR) {
    load_tile(sQ, LD, qg + q0, lq, DP, T, d, T);
  } else {
    load_tile(sQ, LD, qg + (size_t)q0 * d, d, T, DP, T, d);
  }
  float live = 0.f;
  for (int k0 = 0; k0 < lk; k0 += T) {
    __syncthreads();
    if (DMAJOR) {
      load_tile(sK, LD, kg + k0, lk, DP, T, d, T);
    } else {
      load_tile(sK, LD, kg + (size_t)k0 * d, d, T, DP, T, d);
    }
    __syncthreads();
    float s[8][4];
#pragma unroll
    for (int j = 0; j < 8; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < DP / 16; ++kk) {
      uint32_t a[4];
      if (DMAJOR) {
        ldmatrix_x4_trans(a, sQ + (kk * 16 + lane % 8 + (lane / 16) * 8) * LD + 16 * warp +
                                 ((lane / 8) % 2) * 8);
      } else {
        ldmatrix_x4(a, sQ + (16 * warp + lane % 16) * LD + kk * 16 + (lane / 16) * 8);
      }
#pragma unroll
      for (int jp = 0; jp < 4; ++jp) {
        uint32_t b[4];
        if (DMAJOR) {
          ldmatrix_x4_trans(b, sK + (kk * 16 + lane % 8 + ((lane / 8) % 2) * 8) * LD +
                                   jp * 16 + (lane / 16) * 8);
        } else {
          ldmatrix_x4(b, sK + (jp * 16 + lane % 8 + (lane / 16) * 8) * LD + kk * 16 +
                             ((lane / 8) % 2) * 8);
        }
        mma_bf16(s[2 * jp], a, b[0], b[1]);
        mma_bf16(s[2 * jp + 1], a, b[2], b[3]);
      }
    }
    if (k0 < STORED) {
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const int row = q0 + 16 * warp + lane / 4 + 8 * r;
          const int col = k0 + 8 * j + 2 * (lane % 4);
          *reinterpret_cast<__nv_bfloat162*>(out + ((size_t)g * lq + row) * STORED + col) =
              __floats2bfloat162_rn(s[j][2 * r], s[j][2 * r + 1]);
        }
    } else {
#pragma unroll
      for (int j = 0; j < 8; ++j) live += (s[j][0] + s[j][1]) + (s[j][2] + s[j][3]);
    }
  }
  if (sink) sink[((size_t)g * gridDim.x + blockIdx.x) * kThreads + threadIdx.x] = live;
}

// Arm 2: O = P V with O's d columns in ND tiles of 8 (no padding), stored
// zero-padded to 128 columns.
template <int ND>
__global__ void __launch_bounds__(kThreads)
probe_pv_kernel(const bf16* __restrict__ p, const bf16* __restrict__ v, bf16* __restrict__ out,
                int lq, int lk, int d) {
  constexpr int LV = DN + 8;
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* sP = reinterpret_cast<bf16*>(smem);
  bf16* sV = sP + T * LT;

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int q0 = blockIdx.x * T;
  const int g = blockIdx.y;
  const bf16* pg = p + ((size_t)g * lq + q0) * lk;
  const bf16* vg = v + (size_t)g * lk * d;
  float o[ND][4];
#pragma unroll
  for (int n = 0; n < ND; ++n) o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0.f;
  for (int k0 = 0; k0 < lk; k0 += T) {
    __syncthreads();
    load_tile(sP, LT, pg + k0, lk, T, T, T, T);
    load_tile(sV, LV, vg + (size_t)k0 * d, d, T, DN, T, d);
    __syncthreads();
#pragma unroll
    for (int t = 0; t < T / 16; ++t) {
      uint32_t a[4];
      ldmatrix_x4(a, sP + (16 * warp + lane % 16) * LT + t * 16 + (lane / 16) * 8);
#pragma unroll
      for (int n = 0; n < ND; ++n) {
        uint32_t b[2];
        ldmatrix_x2_trans(b, sV + (t * 16 + lane % 8 + ((lane / 8) % 2) * 8) * LV + n * 8);
        mma_bf16(o[n], a, b[0], b[1]);
      }
    }
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = q0 + 16 * warp + lane / 4 + 8 * r;
    bf16* orow = out + ((size_t)g * lq + row) * STORED;
#pragma unroll
    for (int n = 0; n < ND; ++n) {
      *reinterpret_cast<__nv_bfloat162*>(orow + 8 * n + 2 * (lane % 4)) =
          __floats2bfloat162_rn(o[n][2 * r], o[n][2 * r + 1]);
    }
    for (int col = 8 * ND + 2 * (lane % 4); col < STORED; col += 8) {
      *reinterpret_cast<__nv_bfloat162*>(orow + col) = __floats2bfloat162_rn(0.f, 0.f);
    }
  }
}

// Arm 3: O^T = V^T P^T, (d, lq), d padded to DN output rows (3 m16 tiles).
__global__ void __launch_bounds__(kThreads)
probe_pv_dmajor_kernel(const bf16* __restrict__ v, const bf16* __restrict__ p,
                       bf16* __restrict__ out, int lq, int lk, int d) {
  constexpr int MT = DN / 16;
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* sVt = reinterpret_cast<bf16*>(smem);  // (DN d rows, 64 keys)
  bf16* sP = sVt + DN * LT;                   // (64 q rows, 64 keys)

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int q0 = blockIdx.x * T;
  const int g = blockIdx.y;
  const bf16* vg = v + (size_t)g * d * lk;
  const bf16* pg = p + ((size_t)g * lq + q0) * lk;
  float o[MT][2][4];
#pragma unroll
  for (int m = 0; m < MT; ++m)
#pragma unroll
    for (int n = 0; n < 2; ++n) o[m][n][0] = o[m][n][1] = o[m][n][2] = o[m][n][3] = 0.f;
  for (int k0 = 0; k0 < lk; k0 += T) {
    __syncthreads();
    load_tile(sVt, LT, vg + k0, lk, DN, T, d, T);
    load_tile(sP, LT, pg + k0, lk, T, T, T, T);
    __syncthreads();
#pragma unroll
    for (int t = 0; t < T / 16; ++t) {
      uint32_t b[4];
      ldmatrix_x4(b, sP + (16 * warp + lane % 8 + (lane / 16) * 8) * LT + t * 16 +
                         ((lane / 8) % 2) * 8);
#pragma unroll
      for (int m = 0; m < MT; ++m) {
        uint32_t a[4];
        ldmatrix_x4(a, sVt + (16 * m + lane % 16) * LT + t * 16 + (lane / 16) * 8);
        mma_bf16(o[m][0], a, b[0], b[1]);
        mma_bf16(o[m][1], a, b[2], b[3]);
      }
    }
  }
#pragma unroll
  for (int m = 0; m < MT; ++m)
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = 16 * m + lane / 4 + 8 * r;
      if (row >= d) continue;
#pragma unroll
      for (int n = 0; n < 2; ++n) {
        const int col = q0 + 16 * warp + 8 * n + 2 * (lane % 4);
        *reinterpret_cast<__nv_bfloat162*>(out + ((size_t)g * d + row) * lq + col) =
            __floats2bfloat162_rn(o[m][n][2 * r], o[m][n][2 * r + 1]);
      }
    }
}

template <int DP, bool DMAJOR>
int launch_qk(const void* q, const void* k, void* out, void* sink, int G, int lq, int lk, int d,
              cudaStream_t stream) {
  const int rows = DMAJOR ? DP : T;
  const int ld = DMAJOR ? LT : DP + 8;
  const size_t bytes = sizeof(bf16) * 2 * rows * ld;
  auto kernel = probe_qk_kernel<DP, DMAJOR>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return (int)err;
  kernel<<<dim3(lq / T, G), kThreads, bytes, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<bf16*>(out),
      static_cast<float*>(sink), lq, lk, d);
  return (int)cudaGetLastError();
}

template <int ND>
int launch_pv(const void* p, const void* v, void* out, int G, int lq, int lk, int d,
              cudaStream_t stream) {
  const size_t bytes = sizeof(bf16) * (T * LT + T * (DN + 8));
  probe_pv_kernel<ND><<<dim3(lq / T, G), kThreads, bytes, stream>>>(
      static_cast<const bf16*>(p), static_cast<const bf16*>(v), static_cast<bf16*>(out), lq,
      lk, d);
  return (int)cudaGetLastError();
}

}  // namespace

// arm: 0 qk_lanes, 1 qk_sublanes, 2 pv_lanes, 3 pv_dmajor (see above); a and
// b are the arm's two inputs in that order, G problems each, contiguous.
// lq and lk are multiples of 64; the QK arms take d <= 48 or d = 128 and
// lk >= 128, the PV arms d <= 48; d is a multiple of 8. `sink` is null in
// every real call.
extern "C" int hv_probe_dmajor(int arm, const void* a, const void* b, void* out, void* sink,
                               int G, int lq, int lk, int d, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (G <= 0 || G > 65535 || lq <= 0 || lk <= 0 || lq % T || lk % T || d <= 0 || d % 8)
    return (int)cudaErrorInvalidValue;
  switch (arm) {
    case 0:
    case 1:
      if (lk < STORED) return (int)cudaErrorInvalidValue;
      if (d <= DN)
        return arm == 0 ? launch_qk<DN, false>(a, b, out, sink, G, lq, lk, d, s)
                        : launch_qk<DN, true>(a, b, out, sink, G, lq, lk, d, s);
      if (d == 128)
        return arm == 0 ? launch_qk<128, false>(a, b, out, sink, G, lq, lk, d, s)
                        : launch_qk<128, true>(a, b, out, sink, G, lq, lk, d, s);
      return (int)cudaErrorInvalidValue;
    case 2:
      switch (d / 8) {
        case 1: return launch_pv<1>(a, b, out, G, lq, lk, d, s);
        case 2: return launch_pv<2>(a, b, out, G, lq, lk, d, s);
        case 3: return launch_pv<3>(a, b, out, G, lq, lk, d, s);
        case 4: return launch_pv<4>(a, b, out, G, lq, lk, d, s);
        case 5: return launch_pv<5>(a, b, out, G, lq, lk, d, s);
        case 6: return launch_pv<6>(a, b, out, G, lq, lk, d, s);
        default: return (int)cudaErrorInvalidValue;
      }
    case 3: {
      if (d > DN) return (int)cudaErrorInvalidValue;
      const size_t bytes = sizeof(bf16) * (DN + T) * LT;
      probe_pv_dmajor_kernel<<<dim3(lq / T, G), kThreads, bytes, s>>>(
          static_cast<const bf16*>(a), static_cast<const bf16*>(b), static_cast<bf16*>(out), lq,
          lk, d);
      return (int)cudaGetLastError();
    }
    default:
      return (int)cudaErrorInvalidValue;
  }
}

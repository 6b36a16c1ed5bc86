// Streaming probe: y = x * c + 0.5 over a contiguous bf16 tensor, for Hopper
// (sm_90a). One read and one write of every element: its time is the card's
// streaming rate.
//
// Replaces: tools/microbench.py, `probe_hbm`'s Pallas map `pmap_kernel`
// (`pallas_map`), which streams `x_ref[...] * 1.0001 + 0.5` over (rows,
// lanes) blocks.
//
// Rounding, as the TPU kernel rounds: the Python constant is weakly typed,
// so JAX rounds it to bf16 first (bf16(1.0001) is exactly 1.0), and each
// operation rounds to bf16: y = bf16(bf16(x * bf16(c)) + 0.5). The wrapper
// passes c already rounded to bf16, as a float.
//
// What bounds it on the H100: bytes. 2 bytes read and 2 written per element
// (1.6 GB at the VAE decode's (8, 768, 512, 128): 0.48 ms at 3.35 TB/s);
// two bf16 operations per element are nothing against that.
//
// Design: a grid-stride loop over 16-byte vectors (8 elements), enough
// blocks for several waves of 132 SMs, neighbouring threads on neighbouring
// vectors; the ragged tail (n % 8 elements) is one scalar pass.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ __nv_bfloat16 map_one(__nv_bfloat16 x, float c) {
  const __nv_bfloat16 t = __float2bfloat16_rn(__bfloat162float(x) * c);
  return __float2bfloat16_rn(__bfloat162float(t) + 0.5f);
}

__global__ void __launch_bounds__(kThreads)
probe_hbm_kernel(const uint4* __restrict__ x, uint4* __restrict__ y, long long n_vec,
                 const __nv_bfloat16* __restrict__ x_tail, __nv_bfloat16* __restrict__ y_tail,
                 int n_tail, float c) {
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n_vec; i += stride) {
    uint4 v = x[i];
    __nv_bfloat16* e = reinterpret_cast<__nv_bfloat16*>(&v);
#pragma unroll
    for (int j = 0; j < 8; ++j) e[j] = map_one(e[j], c);
    y[i] = v;
  }
  if (blockIdx.x == 0 && (int)threadIdx.x < n_tail) {
    y_tail[threadIdx.x] = map_one(x_tail[threadIdx.x], c);
  }
}

}  // namespace

// x, y: n contiguous bf16 values, 16-byte aligned; c: the constant, already
// rounded to bf16. `blocks` is the grid size (the wrapper aims at a few
// waves of the SMs).
extern "C" int hv_probe_hbm(const void* x, void* y, long long n, float c, int blocks,
                            void* stream) {
  if (n <= 0 || blocks <= 0) return (int)cudaErrorInvalidValue;
  const long long n_vec = n / 8;
  const int n_tail = (int)(n % 8);
  const __nv_bfloat16* xb = static_cast<const __nv_bfloat16*>(x);
  __nv_bfloat16* yb = static_cast<__nv_bfloat16*>(y);
  probe_hbm_kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      reinterpret_cast<const uint4*>(xb), reinterpret_cast<uint4*>(yb), n_vec,
      xb + n_vec * 8, yb + n_vec * 8, n_tail, c);
  return (int)cudaGetLastError();
}

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
// Design: one block of 256 threads for every kUnroll x 256 16-byte vectors,
// each thread kUnroll of them (neighbouring threads on neighbouring
// vectors), so that blocks start in address order and the card's whole
// set of resident blocks sweeps one contiguous window of memory; this is
// the grid `torch.add` launches, and it reaches the same time. Two designs
// that keep more bytes in flight lost 4-7% against it (`python -m
// humanvid_tpu_torch.tools.flash_variants --hbm` times them all):
//   - a grid of one wave of resident blocks in a grid-stride loop (kWaves =
//     1), with kUnroll = 4 independent 16-byte loads a thread before its
//     first store;
//   - a bulk ring (kBulkRing = true): one persistent block per resident slot
//     streams kChunk-byte chunks through a kStages-deep ring in shared
//     memory: 1-D bulk copies global -> shared complete on an mbarrier, the
//     block maps the chunk in place, and a bulk copy shared -> global writes
//     it back; a stage is refilled once its store has read it.
// Both keep persistent blocks, which drift apart over the array (the likely
// cost, with more DRAM pages open at once; the card's memory counters are
// not read here). The ragged tail (n % 8 elements) is one scalar pass of
// block 0; the bulk ring's last chunk is shorter, a multiple of 16 bytes.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include <algorithm>

#include "hopper.cuh"

namespace {

using namespace hopper;

constexpr bool kBulkRing = false;
constexpr int kThreads = 256;
constexpr int kUnroll = 1;      // 16-byte loads in flight per thread (unrolled)
constexpr int kWaves = 0;       // grid cap in waves of resident blocks; 0: none (unrolled)
constexpr int kChunk = 32768;   // bytes per ring stage (bulk ring)
constexpr int kStages = 4;

__device__ __forceinline__ __nv_bfloat16 map_one(__nv_bfloat16 x, float c) {
  const __nv_bfloat16 t = __float2bfloat16_rn(__bfloat162float(x) * c);
  return __float2bfloat16_rn(__bfloat162float(t) + 0.5f);
}

__device__ __forceinline__ uint4 map_vec(uint4 v, float c) {
  __nv_bfloat16* e = reinterpret_cast<__nv_bfloat16*>(&v);
#pragma unroll
  for (int j = 0; j < 8; ++j) e[j] = map_one(e[j], c);
  return v;
}

__device__ __forceinline__ void map_tail(const __nv_bfloat16* x_tail, __nv_bfloat16* y_tail,
                                         int n_tail, float c) {
  if (blockIdx.x == 0 && (int)threadIdx.x < n_tail)
    y_tail[threadIdx.x] = map_one(x_tail[threadIdx.x], c);
}

__global__ void __launch_bounds__(kThreads)
probe_hbm_kernel(const uint4* __restrict__ x, uint4* __restrict__ y, long long n_vec,
                 const __nv_bfloat16* __restrict__ x_tail, __nv_bfloat16* __restrict__ y_tail,
                 int n_tail, float c) {
  const long long stride = (long long)gridDim.x * kThreads * kUnroll;
  for (long long i0 = (long long)blockIdx.x * kThreads * kUnroll + threadIdx.x; i0 < n_vec;
       i0 += stride) {
    uint4 v[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const long long i = i0 + (long long)u * kThreads;
      if (i < n_vec) v[u] = x[i];
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const long long i = i0 + (long long)u * kThreads;
      if (i < n_vec) y[i] = map_vec(v[u], c);
    }
  }
  map_tail(x_tail, y_tail, n_tail, c);
}

__global__ void __launch_bounds__(kThreads, 1)
probe_hbm_ring_kernel(const unsigned char* __restrict__ x, unsigned char* __restrict__ y,
                      long long n_bytes, const __nv_bfloat16* __restrict__ x_tail,
                      __nv_bfloat16* __restrict__ y_tail, int n_tail, float c) {
  extern __shared__ __align__(128) unsigned char ring[];
  uint64_t* full = reinterpret_cast<uint64_t*>(ring + kStages * kChunk);
  const long long n_chunks = (n_bytes + kChunk - 1) / kChunk;
  // this block's chunks: blockIdx.x + i * gridDim.x for i < count
  const int count = blockIdx.x < n_chunks
                        ? (int)((n_chunks - 1 - blockIdx.x) / gridDim.x) + 1 : 0;
  auto chunk_bytes = [&](int i) {
    const long long off = ((long long)blockIdx.x + (long long)i * gridDim.x) * kChunk;
    const long long left = n_bytes - off;
    return (uint32_t)(left < kChunk ? left : kChunk);
  };
  auto load = [&](int i) {
    const int s = i % kStages;
    const uint32_t bytes = chunk_bytes(i);
    mbar_arrive_expect_tx(&full[s], bytes);
    bulk_load(ring + s * kChunk,
              x + ((long long)blockIdx.x + (long long)i * gridDim.x) * kChunk, bytes, &full[s]);
  };
  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) mbar_init(&full[s], 1);
    fence_barrier_init();
  }
  __syncthreads();
  if (threadIdx.x == 0)
    for (int i = 0; i < kStages && i < count; ++i) load(i);
  for (int i = 0; i < count; ++i) {
    const int s = i % kStages;
    const uint32_t bytes = chunk_bytes(i);
    mbar_wait(&full[s], (i / kStages) & 1);
    uint4* v = reinterpret_cast<uint4*>(ring + s * kChunk);
    for (uint32_t j = threadIdx.x; j < bytes / 16; j += kThreads) v[j] = map_vec(v[j], c);
    fence_proxy_async();  // the generic writes before the bulk store reads them
    __syncthreads();
    if (threadIdx.x == 0) {
      bulk_store(y + ((long long)blockIdx.x + (long long)i * gridDim.x) * kChunk,
                 ring + s * kChunk, bytes);
      bulk_commit();
      // the previous chunk's store has read its stage: refill that stage
      if (i >= 1 && i - 1 + kStages < count) {
        bulk_wait<1, true>();
        load(i - 1 + kStages);
      }
    }
  }
  if (threadIdx.x == 0) bulk_wait<0, false>();
  map_tail(x_tail, y_tail, n_tail, c);
}

// Blocks of `kernel` resident on the current device at once (cached per
// device).
template <class Kernel>
int resident_blocks(Kernel kernel, int smem) {
  static int cached[64] = {0};
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess || dev < 0 || dev >= 64) return 0;
  if (!cached[dev]) {
    int sms = 0, per_sm = 0;
    if (cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess ||
        cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads, smem) !=
            cudaSuccess)
      return 0;
    cached[dev] = sms * per_sm;
  }
  return cached[dev];
}

}  // namespace

// x, y: n contiguous bf16 values, 16-byte aligned; c: the constant, already
// rounded to bf16. `blocks` caps the grid, which is no larger than the work
// fills (and, for the persistent designs, than one wave of resident blocks).
extern "C" int hv_probe_hbm(const void* x, void* y, long long n, float c, int blocks,
                            void* stream) {
  if (n <= 0 || blocks <= 0) return (int)cudaErrorInvalidValue;
  const long long n_vec = n / 8;
  const int n_tail = (int)(n % 8);
  const __nv_bfloat16* xb = static_cast<const __nv_bfloat16*>(x);
  __nv_bfloat16* yb = static_cast<__nv_bfloat16*>(y);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if constexpr (kBulkRing) {
    constexpr int smem = kStages * kChunk + kStages * 8;
    const cudaError_t e = cudaFuncSetAttribute(
        probe_hbm_ring_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return (int)e;
    const int wave = resident_blocks(probe_hbm_ring_kernel, smem);
    if (wave <= 0) return (int)cudaErrorInvalidValue;
    const long long chunks = (n_vec * 16 + kChunk - 1) / kChunk;
    const long long grid = std::max(1LL, std::min({(long long)blocks, (long long)wave, chunks}));
    probe_hbm_ring_kernel<<<(int)grid, kThreads, smem, s>>>(
        reinterpret_cast<const unsigned char*>(xb), reinterpret_cast<unsigned char*>(yb),
        n_vec * 16, xb + n_vec * 8, yb + n_vec * 8, n_tail, c);
  } else {
    const long long steps = (n_vec + kThreads * kUnroll - 1) / (kThreads * kUnroll);
    long long grid = std::min((long long)blocks, steps);
    if (kWaves > 0) {
      const int wave = resident_blocks(probe_hbm_kernel, 0);
      if (wave <= 0) return (int)cudaErrorInvalidValue;
      grid = std::min(grid, (long long)kWaves * wave);
    }
    grid = std::max(1LL, grid);
    probe_hbm_kernel<<<(int)grid, kThreads, 0, s>>>(
        reinterpret_cast<const uint4*>(xb), reinterpret_cast<uint4*>(yb), n_vec,
        xb + n_vec * 8, yb + n_vec * 8, n_tail, c);
  }
  return (int)cudaGetLastError();
}

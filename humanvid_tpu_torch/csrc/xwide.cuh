// Kernel A past 512 columns (the xwide kernels of csrc/flash_attention.cu
// and csrc/flash_attention_bwd.cu): what the forward and the backward share.
//
// A head of d > 512 columns is cut into slices of SL columns (SL = 128 or
// 256, a template parameter; `xwide_plan` in ops/flash_attention.py picks
// it). A thread-block cluster of n <= 8 blocks owns one 64-row tile of
// one head: block `rank` reads only the columns of its slices. The logits
// (S = Q K^T, and the backward's dP = G V^T) are sums over the head's
// depth, so each block computes its partial over its columns with `wgmma`
// and the cluster adds the n partials over distributed shared memory, in
// rank order: every block gets the same bits of S, so the same softmax.
//
// Slices, clusters and groups. The head's slices are numbered idx = 0..;
// slice idx holds columns idx * SL .. + SL, those past d read as zeros.
// The grid's x axis walks (tile, group, rank); a cluster of group g gives
// block `rank` the depth slices rank + n * jj for jj < groups (its share
// of S's sum) and makes it write the output columns of slice rank + n * g
// (its slice jj = g). With groups = 1 (every d <= n * SL <= 2048 at SL =
// 256) a block's depth slice is its output slice. Past one cluster's
// reach each group's cluster computes the whole S again: the one place
// where S is recomputed.
//
// Tiles. Every piece a block loads is 64 rows x SL columns of one head,
// TMA boxes of 64 columns in the 128-byte swizzle through a 4-D map (d,
// heads, L, B) (`make_head_map`): the columns of a box past the head's
// last column read zeros (a box wholly past it all zeros), never the next
// head's columns, and rows past L read zeros. So every product runs over
// the whole slice, the same wgmma chain in every block and at every width
// (no branch or loop of a run-time length around a wgmma, which would make
// ptxas serialize them), and the columns of an output past d are never
// stored. Heads past one cluster's reach (groups > 1) take a kernel of
// their own (EXTRA), whose block also streams its other depth slices.
//
// The exchange. Each consumer warp writes its 16 rows of the partial
// (fp32, thread t's 32 values as 8 float4 at [i][t]) to an exchange buffer
// of its own block; one lane releases the warp's writes to the cluster
// with one fence and arrives (relaxed) on the matching barrier of every
// block of the cluster; the warp waits for the cluster's n arrivals on its
// own (acquire at cluster scope), reads the same thread's values from
// every other block (`ld.shared::cluster`, four of a block in flight
// together), sums the n in rank order, and arrives on every block's
// `empty` barrier of that buffer. A buffer is written again only after
// its `empty` phase completes; with two buffers one tile's exchange waits
// on nothing of the next tile's. Thread t of every block holds the same
// fragment positions, so a warp waits only for the same warp of the other
// blocks. (A cluster-scope release on every arrival, and loads issued one
// at a time, took 80% of the forward's time on the H100.)
#pragma once

#include "hopper.cuh"

namespace xwide {

using namespace hopper;

constexpr int kRows = 64;  // rows of every piece: a query tile, a key tile
constexpr int kBox = 64;   // columns of one TMA box
constexpr int kBoxBytes = kRows * kBox * 2;
constexpr int kMaxCluster = 8;  // the portable cluster size
constexpr int kInfoSlots = 3;   // the per-step words ring
constexpr int kInfoBytes = 2 * kRows * 4 + 16;  // two words a streamed row, the skip flag
constexpr int kXBytes = kRows * kRows * 4;      // one 64 x 64 fp32 partial
constexpr int kSmemLimit = 232448;

// The plan the wrapper computes (`xwide_plan`) and passes in.
struct Plan {
  int slice, cluster, groups, key_tile, stages, xbufs, smem;
};

// Byte offsets of a block's shared memory from a 1024-byte boundary: the
// two resident pieces (the forward's two Q slices; the backward's two
// owned slices), the ring of `stages` pieces, `xbufs` exchange buffers of
// a partial for each of the two consumer warpgroups, the words ring, the
// barriers; `bytes` adds the alignment. ops/flash_attention.py's
// `xwide_smem` reckons the same.
struct Layout {
  int piece, off_ring, off_x, off_info, off_bar, bars, bytes;
  __host__ __device__ Layout(int slice, int stages, int xbufs) {
    piece = kRows * slice * 2;
    off_ring = 2 * piece;
    off_x = off_ring + stages * piece;
    off_info = off_x + xbufs * 2 * kXBytes;
    off_bar = off_info + kInfoSlots * kInfoBytes;
    bars = 2 * stages + 2 * kInfoSlots + 1 + 2 * xbufs * 2 * 4;
    bytes = off_bar + bars * 8 + 1024;
  }
};

// Whether the kernels take the plan for a d-wide head, and its shared
// memory is what they lay out.
inline bool plan_ok(const Plan& p, int d) {
  if ((p.slice != 128 && p.slice != 256) || p.key_tile != kRows) return false;
  if (p.cluster < 1 || p.cluster > kMaxCluster || p.groups < 1) return false;
  if ((long long)p.cluster * p.groups * p.slice < d) return false;
  if (p.stages < 2 || p.xbufs < 1 || p.xbufs > 2) return false;
  const Layout L(p.slice, p.stages, p.xbufs);
  return p.smem == L.bytes && L.bytes <= kSmemLimit;
}

// Columns of slice idx inside the head.
__device__ __forceinline__ int slice_cols(int idx, int slice, int d) {
  return max(0, min(slice, d - idx * slice));
}

// Byte offset of the 16-deep step kk of a 64-row piece, K-major.
__device__ __forceinline__ uint32_t kstep(int kk) {
  return (kk / 4) * kBoxBytes + (kk % 4) * 32;
}

// x (64 x 64, fp32) = A B^T over a slice's SL columns (+ x if
// `accumulate`), A and B 64-row pieces (K-major) at the descriptors'
// start addresses.
template <int SL>
__device__ __forceinline__ void partial_product(float (&x)[32], uint64_t a_desc, uint64_t b_desc,
                                                bool accumulate) {
#pragma unroll
  for (int kk = 0; kk < SL / 16; ++kk)
    WgmmaSS<64>::run(x, a_desc + (kstep(kk) >> 4), b_desc + (kstep(kk) >> 4),
                     accumulate || kk > 0);
}

// The exchange of one partial (the header): `buf` is this block's buffer,
// `full` and `empty` this warp's barriers of it, `use` how often the
// buffer was used before, `xbufs` the buffers. On return x holds the sum
// of the cluster's n partials in rank order. With one buffer every reader
// arrives on `empty` and the next write waits for it; with two, a block
// that passed the `full` phase of one buffer knows that every block has
// read its other buffer (a block arrives on `full` after it read the
// last partials), and `empty` is used once, by `drain`.
__device__ __forceinline__ void exchange(float (&x)[32], float* buf, uint64_t* full,
                                         uint64_t* empty, int use, int xbufs, int n, int rank,
                                         int t, int lane) {
  if (xbufs == 1 && use > 0) mbar_wait(empty, (use - 1) & 1);  // the cluster read the last one
  float4* mine = reinterpret_cast<float4*>(buf) + t;
#pragma unroll
  for (int i = 0; i < 8; ++i)
    mine[i * 128] = make_float4(x[4 * i], x[4 * i + 1], x[4 * i + 2], x[4 * i + 3]);
  __syncwarp();
  if (lane == 0) {
    fence_acq_rel_cluster();  // the warp's writes, released to the cluster once
    for (int r = 0; r < n; ++r) mbar_arrive_cluster(full, (uint32_t)r);
  }
  mbar_wait_cluster(full, use & 1);
  // half the slots at a time: each block's four loads in flight together,
  // the sums in rank order
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    float4 s[4];
#pragma unroll
    for (int r = 0; r < kMaxCluster; ++r) {
      if (r >= n) break;
      float4 v[4];
      if (r == rank) {
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          const int i = 4 * half + k;
          v[k] = make_float4(x[4 * i], x[4 * i + 1], x[4 * i + 2], x[4 * i + 3]);
        }
      } else {
        const uint32_t peer = dsmem_addr(mine + half * 4 * 128, (uint32_t)r);
#pragma unroll
        for (int k = 0; k < 4; ++k) v[k] = ld_dsmem_f4(peer + k * 128 * 16);
      }
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        if (r == 0) {
          s[k] = v[k];
        } else {
          s[k].x += v[k].x;
          s[k].y += v[k].y;
          s[k].z += v[k].z;
          s[k].w += v[k].w;
        }
      }
    }
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const int i = 4 * half + k;
      x[4 * i] = s[k].x;
      x[4 * i + 1] = s[k].y;
      x[4 * i + 2] = s[k].z;
      x[4 * i + 3] = s[k].w;
    }
  }
  fence_regs(x);  // every load's value is in before the arrivals below
  if (xbufs == 1) {
    __syncwarp();
    if (lane == 0)
      for (int r = 0; r < n; ++r) mbar_arrive_cluster(empty, (uint32_t)r);
  }
}

// Wait until the cluster has read this warp's partial of exchange `use`
// (one buffer), so that the buffer may take other data.
__device__ __forceinline__ void wait_read(uint64_t* empty, int use) {
  mbar_wait(empty, use & 1);
}

// Wait until the cluster has read every partial this warp wrote (`uses`
// exchanges, buffer 0's `empty` barrier at `empty0`): a block leaves only
// then, and the last arrivals on its barriers have come.
__device__ __forceinline__ void drain(uint64_t* empty0, int xbufs, int uses, int n, int lane) {
  if (uses == 0) return;
  if (xbufs == 1) {
    mbar_wait(empty0, (uses - 1) & 1);
    return;
  }
  __syncwarp();
  if (lane == 0)
    for (int r = 0; r < n; ++r) mbar_arrive_cluster(empty0, (uint32_t)r);
  mbar_wait(empty0, 0);
}

// TMA loads of slice idx's 64 rows from row r0 into `dst`, completing on
// `bar` (one thread; the caller adds the slice's bytes to the barrier's
// count).
__device__ __forceinline__ void load_slice(unsigned char* dst, const CUtensorMap* map,
                                           uint64_t* bar, int idx, int slice, int h, int r0,
                                           int b) {
  for (int i = 0; i < slice / kBox; ++i)
    tma_load_4d(dst + i * kBoxBytes, map, bar, idx * slice + i * kBox, h, r0, b);
}

// The ring of pieces. The producer warp `put`s slice idx's 64 rows from
// row r0 into the next slot; each consumer warp `take`s the next slot in
// the same order and `release`s it when its products have read it. A warp
// releases only slots it took, so no release runs ahead of its use.
struct Ring {
  unsigned char* base;
  uint64_t* full;
  uint64_t* empty;
  int stages, piece, slice, h, b, count;

  __device__ __forceinline__ void put(const CUtensorMap* map, int idx, int r0, int lane) {
    const int s = count % stages;
    mbar_wait(&empty[s], ((count / stages) & 1) ^ 1);
    if (lane == 0) {
      mbar_arrive_expect_tx(&full[s], piece);
      load_slice(base + s * piece, map, &full[s], idx, slice, h, r0, b);
    }
    ++count;
  }

  __device__ __forceinline__ int take() {
    const int s = count % stages;
    mbar_wait(&full[s], (count / stages) & 1);
    ++count;
    return s;
  }

  __device__ __forceinline__ void release(int s, int lane) {
    __syncwarp();
    if (lane == 0) mbar_arrive(&empty[s]);
  }
};

}  // namespace xwide

// Fused corpus scoring + per-tile top-kk selection.
//
// Replaces repro/kernels/scoretopk/scoretopk.py: score_topk_pallas (body
// _kernel).  Same contract: for every tile of `tile` corpus rows and every
// query, the kk best (score desc, row asc) as float32 values and global
// int32 row ids; rows >= n_rows score -inf, and once a tile runs out of
// finite scores the remaining slots are (-inf, n_rows).
//
// Bound on an H100: bytes (the whole corpus is read once per call; the
// scores never reach device memory).  Design: one block per (tile, query),
// consecutive blocks on the same tile so a tile read by the first query is
// served from L2 for the others.  A warp computes one row's dot product at
// a time with coalesced loads, in float32 as the TPU kernel does: each lane
// accumulates its strided products with fmaf, then a shuffle tree sums the
// 32 partials — no TF32 or other reduced precision anywhere.  The summation
// order differs from a BLAS product's, so scores agree with the plain
// version to float32 rounding, not bit for bit.  The tile's scores
// stay in shared memory; selection is kk rounds of block-wide
// (max, lowest row) reduction and masking, the TPU kernel's iterative
// max/argmax/mask, with each thread caching the best of its own columns.

#include <cfloat>
#include <climits>
#include <cmath>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr unsigned kFull = 0xffffffffu;

// (v1, c1) ranks before (v2, c2): higher score, then lower column
__device__ __forceinline__ bool better(float v1, int c1, float v2, int c2) {
  return v1 > v2 || (v1 == v2 && c1 < c2);
}

__device__ __forceinline__ void warp_best(float& v, int& c) {
  for (int off = 16; off > 0; off >>= 1) {
    const float ov = __shfl_down_sync(kFull, v, off);
    const int oc = __shfl_down_sync(kFull, c, off);
    if (better(ov, oc, v, c)) {
      v = ov;
      c = oc;
    }
  }
}

__device__ __forceinline__ void local_best(const float* sc, int tile,
                                           float& v, int& c) {
  v = -INFINITY;
  c = INT_MAX;
  for (int col = threadIdx.x; col < tile; col += kThreads) {
    if (better(sc[col], col, v, c)) {
      v = sc[col];
      c = col;
    }
  }
}

__global__ void __launch_bounds__(kThreads)
score_topk_kernel(const float* __restrict__ queries,
                  const float* __restrict__ corpus, float* __restrict__ vals,
                  int32_t* __restrict__ idx, int batch, int n_rows, int dim,
                  int kk, int tile) {
  extern __shared__ float smem[];
  float* qv = smem;         // [dim]
  float* sc = smem + dim;   // [tile]
  __shared__ float warp_v[kWarps];
  __shared__ int warp_c[kWarps];
  __shared__ float best_v;
  __shared__ int best_c;

  const int qb = blockIdx.x % batch;
  const int tl = blockIdx.x / batch;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int64_t row0 = static_cast<int64_t>(tl) * tile;

  for (int d = threadIdx.x; d < dim; d += kThreads) {
    qv[d] = queries[static_cast<int64_t>(qb) * dim + d];
  }
  __syncthreads();

  for (int r = warp; r < tile; r += kWarps) {
    const int64_t row = row0 + r;
    float s = -INFINITY;
    if (row < n_rows) {
      const float* e = corpus + row * dim;
      float acc = 0.0f;
      for (int d = lane; d < dim; d += 32) {
        acc = fmaf(qv[d], e[d], acc);
      }
      for (int off = 16; off > 0; off >>= 1) {
        acc += __shfl_down_sync(kFull, acc, off);
      }
      s = acc;
    }
    if (lane == 0) sc[r] = s;
  }
  __syncthreads();

  float mv;
  int mc;
  local_best(sc, tile, mv, mc);
  const int64_t out0 = (static_cast<int64_t>(tl) * batch + qb) * kk;
  for (int j = 0; j < kk; ++j) {
    float v = mv;
    int c = mc;
    warp_best(v, c);
    if (lane == 0) {
      warp_v[warp] = v;
      warp_c[warp] = c;
    }
    __syncthreads();
    if (warp == 0) {
      v = lane < kWarps ? warp_v[lane] : -INFINITY;
      c = lane < kWarps ? warp_c[lane] : INT_MAX;
      warp_best(v, c);
      if (lane == 0) {
        best_v = v;
        best_c = c;
      }
    }
    __syncthreads();
    v = best_v;
    c = best_c;
    if (v == -INFINITY) {  // tile exhausted: pad the rest, uniformly
      for (int jj = j + threadIdx.x; jj < kk; jj += kThreads) {
        vals[out0 + jj] = -INFINITY;
        idx[out0 + jj] = n_rows;
      }
      break;
    }
    if (threadIdx.x == 0) {
      vals[out0 + j] = v;
      idx[out0 + j] = static_cast<int32_t>(row0 + c);
    }
    if (c % kThreads == threadIdx.x) {  // the owner masks and rescans
      sc[c] = -INFINITY;
      local_best(sc, tile, mv, mc);
    }
  }
}

}  // namespace

extern "C" int score_topk_launch(const void* queries, const void* corpus,
                                 void* vals, void* idx, int batch, int n_rows,
                                 int dim, int kk, int tile, void* stream) {
  if (batch <= 0 || n_rows <= 0) return cudaSuccess;
  const int64_t num_tiles = (static_cast<int64_t>(n_rows) + tile - 1) / tile;
  const int64_t blocks = num_tiles * batch;
  if (blocks > INT_MAX) return cudaErrorInvalidValue;
  const size_t smem = static_cast<size_t>(dim + tile) * sizeof(float);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        score_topk_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  score_topk_kernel<<<static_cast<int>(blocks), kThreads, smem,
                      static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(queries), static_cast<const float*>(corpus),
      static_cast<float*>(vals), static_cast<int32_t*>(idx), batch, n_rows,
      dim, kk, tile);
  return cudaGetLastError();
}

// Fused corpus scoring + per-tile top-kk selection.
//
// Replaces repro/kernels/scoretopk/scoretopk.py: score_topk_pallas (body
// _kernel).  Same contract: for every tile of `tile` corpus rows and every
// query, the kk best (score desc, row asc) as float32 values and global
// int32 row ids; rows >= n_rows score -inf, and once a tile runs out of
// finite scores the remaining slots are (-inf, n_rows).
//
// Bound on an H100: bytes.  At batch 8 the work is 4 flops per corpus byte,
// far under the float32 ridge, so what counts is that every corpus byte
// crosses device memory -> SM once and enough bytes are in flight.  Design:
//   * one block per (tile, group of up to 8 queries): the block scores the
//     whole group in one pass over the tile, so the tile reaches the SM
//     once per group (a block per (tile, query) moved it 8 times through
//     L2).  The group's queries (8 x 768 floats) and scores (8 x 2048)
//     stay in shared memory; two blocks fit on an SM at those sizes, so
//     one can select while the other loads;
//   * a warp scores 8 rows at a time, register-tiled: each lane loads its
//     16-byte slices of the 8 rows straight into registers (8 x 16 bytes
//     in flight per lane) and multiplies each query slice it reads from
//     shared memory into all 8 rows.  Float32 FMAs on the CUDA cores, no
//     TF32: each lane accumulates its products with fmaf, then a transpose
//     reduction over the warp's shuffles sums the 32 partials of all
//     8 x G dot products at once.  The summation order differs from a BLAS
//     product's, so scores agree with the plain version to float32
//     rounding, not bit for bit;
//   * selection, one warp per query, from shared memory: a radix select
//     over order-preserving 32-bit keys (-0.0 taken as +0.0, so the two
//     tie and break by row as the plain version's stable sort does) finds
//     the kk-th largest key in at most four 8-bit digit passes (fewer when
//     a digit's bucket is taken whole); the warp then collects every key
//     above it plus the lowest-row ties at it, and a bitonic network sorts
//     those kk entries by (key desc, row asc).

#include <climits>
#include <cmath>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kRows = 8;  // rows a warp scores at a time
constexpr unsigned kFull = 0xffffffffu;

// order-preserving key: a > b as floats iff key(a) > key(b); -0.0 -> +0.0
__device__ __forceinline__ uint32_t order_key(float x) {
  uint32_t u = __float_as_uint(x);
  if ((u << 1) == 0) u = 0;
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}

// Transpose reduction: v[0..N) are one lane's partials of N sums.  Each
// halving step with offset o keeps half of the values (the upper half on
// lanes with bit o set) and adds the partner's copy of them; once one value
// is left the remaining offsets add plainly.  Afterwards v[i] for
// i < max(N / 32, 1) holds the whole warp's sum of partial `slot + i`.
template <int N, int OFF>
__device__ __forceinline__ void transpose_sum(float* v, int lane) {
  if constexpr (OFF > 0) {
    if constexpr (N > 1) {
      constexpr int M = N / 2;
      const bool up = lane & OFF;
#pragma unroll
      for (int i = 0; i < M; ++i) {
        const float send = up ? v[i] : v[i + M];
        const float keep = up ? v[i + M] : v[i];
        v[i] = keep + __shfl_xor_sync(kFull, send, OFF);
      }
      transpose_sum<M, OFF / 2>(v, lane);
    } else {
      v[0] += __shfl_xor_sync(kFull, v[0], OFF);
      transpose_sum<1, OFF / 2>(v, lane);
    }
  }
}

// first partial index held by `lane` after transpose_sum<N, 16>, and
// whether the lane is the one that writes it
template <int N>
__device__ __forceinline__ int transpose_slot(int lane, bool* writer) {
  int slot = 0, m = N;
  *writer = true;
  for (int off = 16; off > 0; off >>= 1) {
    if (m > 1) {
      m >>= 1;
      if (lane & off) slot += m;
    } else if (lane & off) {
      *writer = false;
    }
  }
  return slot;
}

// 16-byte (VEC = 4) or 4-byte loads of a row's slice
template <int VEC>
struct Slice {
  float f[VEC];
};

template <int VEC>
__device__ __forceinline__ Slice<VEC> load_slice(const float* p) {
  Slice<VEC> s;
  if constexpr (VEC == 4) {
    const float4 t = __ldg(reinterpret_cast<const float4*>(p));
    s.f[0] = t.x;
    s.f[1] = t.y;
    s.f[2] = t.z;
    s.f[3] = t.w;
  } else {
    s.f[0] = __ldg(p);
  }
  return s;
}

// Scores of the group's G queries for the tile's rows, into sc[g * tile + r].
template <int G, int VEC>
__device__ __forceinline__ void score_tile(const float* __restrict__ corpus,
                                           const float* qs, float* sc,
                                           int64_t row0, int64_t n_rows,
                                           int dim, int tile) {
  constexpr int NACC = G * kRows;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int chunks = (dim + 32 * VEC - 1) / (32 * VEC);
  bool writer;
  const int slot = transpose_slot<NACC>(lane, &writer);
  for (int r0 = warp * kRows; r0 < tile; r0 += kWarps * kRows) {
    float acc[NACC];
#pragma unroll
    for (int i = 0; i < NACC; ++i) acc[i] = 0.0f;
    // rows r < live of this step exist (inside the tile and the corpus)
    const int64_t first = row0 + r0;
    const int64_t left = n_rows - first;
    int live = tile - r0 < kRows ? tile - r0 : kRows;
    if (left < live) live = left < 0 ? 0 : static_cast<int>(left);
    const float* base = corpus + (live > 0 ? first : 0) *
                                     static_cast<int64_t>(dim);
    for (int c = 0; c < chunks; ++c) {
      const int d = (c * 32 + lane) * VEC;
      if (d >= dim) continue;
      Slice<VEC> e[kRows];
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        if (r < live) {
          e[r] = load_slice<VEC>(base + r * dim + d);
        } else {
#pragma unroll
          for (int w = 0; w < VEC; ++w) e[r].f[w] = 0.0f;
        }
      }
#pragma unroll
      for (int g = 0; g < G; ++g) {
        Slice<VEC> qv;
        if constexpr (VEC == 4) {
          const float4 t = *reinterpret_cast<const float4*>(qs + g * dim + d);
          qv.f[0] = t.x;
          qv.f[1] = t.y;
          qv.f[2] = t.z;
          qv.f[3] = t.w;
        } else {
          qv.f[0] = qs[g * dim + d];
        }
#pragma unroll
        for (int r = 0; r < kRows; ++r) {
#pragma unroll
          for (int w = 0; w < VEC; ++w) {
            acc[g * kRows + r] = fmaf(qv.f[w], e[r].f[w], acc[g * kRows + r]);
          }
        }
      }
    }
    transpose_sum<NACC, 16>(acc, lane);
    if (writer) {
#pragma unroll
      for (int i = 0; i < (NACC >= 32 ? NACC / 32 : 1); ++i) {
        const int g = (slot + i) / kRows;
        const int r = (slot + i) % kRows;
        if (r0 + r < tile) {
          sc[g * tile + r0 + r] = r < live ? acc[i] : -INFINITY;
        }
      }
    }
  }
}

// One warp: the kk best of s[0..tile) by (score desc, row asc) into
// vals/idx; hist (256 words) and keys (p >= kk words of 64 bits, a power of
// two) are the warp's scratch.
__device__ void select_topk(const float* s, int tile, int kk, int p,
                            uint32_t* hist, uint64_t* keys,
                            float* __restrict__ vals,
                            int32_t* __restrict__ idx, int64_t row0,
                            int n_rows) {
  const int lane = threadIdx.x % 32;
  const unsigned lt_mask = (1u << lane) - 1;
  // radix select: after the passes, the selection is every key > thr plus
  // the `need` lowest-row keys == thr
  uint32_t prefix = 0, pmask = 0, thr = 0;
  int krem = kk, need = 0;
  for (int shift = 24; shift >= 0; shift -= 8) {
    for (int i = lane; i < 256; i += 32) hist[i] = 0;
    __syncwarp();
    for (int i = lane; i < tile; i += 32) {
      const uint32_t k = order_key(s[i]);
      if ((k & pmask) == prefix) atomicAdd(&hist[(k >> shift) & 255], 1u);
    }
    __syncwarp();
    // lane l holds buckets 255 - 8l - j (j < 8): counted from the top
    int cnt[8], tot = 0;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      cnt[j] = static_cast<int>(hist[255 - 8 * lane - j]);
      tot += cnt[j];
    }
    int incl = tot;  // inclusive scan over lanes, lane 0 first
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const int o = __shfl_up_sync(kFull, incl, off);
      if (lane >= off) incl += o;
    }
    int run = incl - tot, bucket = -1, above = 0, bcount = 0;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      if (bucket < 0 && run + cnt[j] >= krem) {
        bucket = 255 - 8 * lane - j;
        above = run;
        bcount = cnt[j];
      }
      run += cnt[j];
    }
    const int src = __ffs(__ballot_sync(kFull, bucket >= 0)) - 1;
    bucket = __shfl_sync(kFull, bucket, src);
    above = __shfl_sync(kFull, above, src);
    bcount = __shfl_sync(kFull, bcount, src);
    krem -= above;
    prefix |= static_cast<uint32_t>(bucket) << shift;
    pmask |= 255u << shift;
    if (bcount == krem) {  // the bucket is taken whole: keys >= prefix
      thr = prefix > 0 ? prefix - 1 : 0;  // key 0 is a NaN, never a score
      need = 0;
      break;
    }
    thr = prefix;
    need = krem;
    __syncwarp();
  }
  // collect in row order: ballots give each lane its slot
  int pos = 0, ties = 0;
  for (int b0 = 0; b0 < tile; b0 += 32) {
    const int i = b0 + lane;
    const uint32_t k = i < tile ? order_key(s[i]) : 0;
    const bool eq = i < tile && k == thr;
    const unsigned eqm = __ballot_sync(kFull, eq);
    const bool sel = (i < tile && k > thr) ||
                     (eq && ties + __popc(eqm & lt_mask) < need);
    const unsigned selm = __ballot_sync(kFull, sel);
    if (sel) {
      keys[pos + __popc(selm & lt_mask)] =
          (static_cast<uint64_t>(~k) << 32) | static_cast<uint32_t>(i);
    }
    pos += __popc(selm);
    ties += __popc(eqm);
  }
  for (int i = pos + lane; i < p; i += 32) keys[i] = ~0ull;
  __syncwarp();
  // bitonic sort, ascending: (key desc, row asc)
  for (int size = 2; size <= p; size <<= 1) {
    for (int stride = size / 2; stride > 0; stride >>= 1) {
      for (int t = lane; t < p / 2; t += 32) {
        const int lo = 2 * t - (t & (stride - 1));
        const int hi = lo + stride;
        const uint64_t a = keys[lo], b = keys[hi];
        if ((a > b) == ((lo & size) == 0)) {
          keys[lo] = b;
          keys[hi] = a;
        }
      }
      __syncwarp();
    }
  }
  for (int j = lane; j < kk; j += 32) {
    const uint32_t r = static_cast<uint32_t>(keys[j]);
    const float v = r < static_cast<uint32_t>(tile) ? s[r] : -INFINITY;
    vals[j] = v;
    idx[j] = v == -INFINITY ? n_rows : static_cast<int32_t>(row0 + r);
  }
}

// grid.x = num_tiles * groups, the groups of a tile adjacent
template <int G, int VEC>
__global__ void __launch_bounds__(kThreads, 2)
score_topk_kernel(const float* __restrict__ queries,
                  const float* __restrict__ corpus, float* __restrict__ vals,
                  int32_t* __restrict__ idx, int batch, int n_rows, int dim,
                  int kk, int tile, int p, int groups, int sc_words) {
  extern __shared__ __align__(16) float smem[];
  float* sc = smem;              // [G][tile]
  float* qs = smem + sc_words;   // [G][dim], later the selection scratch
  const int grp = blockIdx.x % groups;
  const int64_t tl = blockIdx.x / groups;
  const int q0 = grp * G;
  const int64_t row0 = tl * tile;

  for (int i = threadIdx.x; i < G * dim; i += kThreads) {
    const int g = i / dim;
    qs[i] = q0 + g < batch
                ? queries[static_cast<int64_t>(q0 + g) * dim + i % dim]
                : 0.0f;
  }
  __syncthreads();
  score_tile<G, VEC>(corpus, qs, sc, row0, n_rows, dim, tile);
  __syncthreads();

  const int g = threadIdx.x / 32;
  if (g < G && q0 + g < batch) {
    auto* scratch = reinterpret_cast<uint32_t*>(qs) + g * (256 + 2 * p);
    const int64_t out0 = (tl * batch + q0 + g) * kk;
    select_topk(sc + g * tile, tile, kk, p, scratch,
                reinterpret_cast<uint64_t*>(scratch + 256), vals + out0,
                idx + out0, row0, n_rows);
  }
}

template <int G, int VEC>
cudaError_t launch(const float* queries, const float* corpus, float* vals,
                   int32_t* idx, int batch, int n_rows, int dim, int kk,
                   int tile, int p, int64_t num_tiles, size_t smem,
                   int sc_words, cudaStream_t stream) {
  const int groups = (batch + G - 1) / G;
  const int64_t blocks = num_tiles * groups;
  if (blocks > INT_MAX) return cudaErrorInvalidValue;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        score_topk_kernel<G, VEC>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  score_topk_kernel<G, VEC><<<static_cast<int>(blocks), kThreads, smem,
                              stream>>>(queries, corpus, vals, idx, batch,
                                        n_rows, dim, kk, tile, p, groups,
                                        sc_words);
  return cudaGetLastError();
}

template <int VEC>
cudaError_t launch_vec(int g, const float* queries, const float* corpus,
                       float* vals, int32_t* idx, int batch, int n_rows,
                       int dim, int kk, int tile, int p, int64_t num_tiles,
                       size_t smem, int sc_words, cudaStream_t stream) {
  switch (g) {
    case 1:
      return launch<1, VEC>(queries, corpus, vals, idx, batch, n_rows, dim,
                            kk, tile, p, num_tiles, smem, sc_words, stream);
    case 2:
      return launch<2, VEC>(queries, corpus, vals, idx, batch, n_rows, dim,
                            kk, tile, p, num_tiles, smem, sc_words, stream);
    case 4:
      return launch<4, VEC>(queries, corpus, vals, idx, batch, n_rows, dim,
                            kk, tile, p, num_tiles, smem, sc_words, stream);
    default:
      return launch<8, VEC>(queries, corpus, vals, idx, batch, n_rows, dim,
                            kk, tile, p, num_tiles, smem, sc_words, stream);
  }
}

}  // namespace

// Shared memory of a block with a group of g queries (bytes): scores, then
// the queries or, once scored, each query's selection scratch (a 256-word
// histogram and p 64-bit sort keys, p the power of two >= kk).
extern "C" size_t score_topk_smem(int g, int dim, int kk, int tile) {
  int p = 1;
  while (p < kk) p <<= 1;
  const size_t sc = (static_cast<size_t>(g) * tile + 3) / 4 * 4;
  const size_t qs = static_cast<size_t>(g) * dim;
  const size_t sel = static_cast<size_t>(g) * (256 + 2 * p);
  return (sc + (qs > sel ? qs : sel)) * sizeof(float);
}

extern "C" int score_topk_launch(const void* queries, const void* corpus,
                                 void* vals, void* idx, int batch, int n_rows,
                                 int dim, int kk, int tile, void* stream) {
  if (batch <= 0 || n_rows <= 0) return cudaSuccess;
  const int64_t num_tiles = (static_cast<int64_t>(n_rows) + tile - 1) / tile;
  // the largest group (8, 4, 2, 1) that the batch fills at least halfway
  // and whose shared memory fits a block
  int g = batch > 4 ? 8 : batch > 2 ? 4 : batch;
  while (g > 1 && score_topk_smem(g, dim, kk, tile) > 227 * 1024) g >>= 1;
  const size_t smem = score_topk_smem(g, dim, kk, tile);
  if (smem > 227 * 1024) return cudaErrorInvalidValue;
  int p = 1;
  while (p < kk) p <<= 1;
  const int sc_words = (g * tile + 3) / 4 * 4;
  const bool vec = dim % 4 == 0 &&
                   reinterpret_cast<uintptr_t>(corpus) % 16 == 0;
  const auto* qp = static_cast<const float*>(queries);
  const auto* cp = static_cast<const float*>(corpus);
  auto* vp = static_cast<float*>(vals);
  auto* ip = static_cast<int32_t*>(idx);
  const auto s = static_cast<cudaStream_t>(stream);
  return vec ? launch_vec<4>(g, qp, cp, vp, ip, batch, n_rows, dim, kk, tile,
                             p, num_tiles, smem, sc_words, s)
             : launch_vec<1>(g, qp, cp, vp, ip, batch, n_rows, dim, kk, tile,
                             p, num_tiles, smem, sc_words, s);
}

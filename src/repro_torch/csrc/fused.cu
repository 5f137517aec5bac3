// Fused cached re-rank for one RNS prime: slot-twiddle rotate ->
// Hadamard against both query components -> raw slot/chunk sum with one
// reduction, optionally followed by the inverse NTT, in one kernel.
//
// Replaces repro/kernels/ntt/fused.py:
//   fused_rerank_pallas       (body _fused_kernel -> _accumulate): the
//                             NTT-domain accumulator pair out — the staged
//                             variant, off the serving path;
//   fused_rerank_intt_pallas  (body _fused_intt_kernel -> _accumulate, then
//                             ntt.inv_butterflies): the serving hot kernel.
//
// Per (lane b, result ciphertext t), for every coefficient k:
//   acc_z[k] = sum_{s < cpt} sum_{c < chunks}
//                (polys[b, t, s*chunks + c, k] * tw[s, k] mod q)
//                * f_z[b, c, k] mod q,          z in {0, 1}
// summed raw in 32 bits (the binding checks rows * (q - 1) < 2^31, as the
// reference asserts) and reduced once.  Both kernels run this sum through
// one device function, `accumulate`; the intt kernel then runs the (2, N)
// accumulator pair through inv_network from modarith.cuh.  The standalone
// inverse NTT (ntt.cu) runs another network (lazy Shoup butterflies), but
// both end in canonical residues, so the staged pair (this file's
// fused_rerank_kernel, then the standalone inverse) and the fused kernel
// agree bit for bit, as `_accumulate` guarantees in the reference.
//
// Bound on an H100: bytes.  Each block reads its cpt*chunks cache rows,
// the twiddles and both query NTTs and writes two rows.  In the intt
// kernel the accumulator pair never leaves shared memory (2 x 16 KiB at
// N = 4096) between the accumulation and the inverse NTT — the TPU
// kernel's VMEM-resident (2, N) tile, one block per grid cell.  The staged
// kernel needs no shared memory: each thread writes its coefficients of
// the pair straight out.

#include "modarith.cuh"

namespace {

constexpr int kMaxThreads = 512;

// acc_z[k] for one coefficient k of one (lane, result ciphertext) cell:
// g is the cell's (cpt*chunks, n) rows, q0/q1 the lane's (chunks, n) query
// NTTs.  Raw 32-bit sum of cpt*chunks products in [0, q), one reduction.
__device__ __forceinline__ void accumulate(
    const int32_t* __restrict__ g, const int32_t* __restrict__ tw,
    const int32_t* __restrict__ q0, const int32_t* __restrict__ q1, int k,
    int n, int cpt, int chunks, uint32_t q, uint64_t m, uint32_t* a0,
    uint32_t* a1) {
  uint32_t s0 = 0, s1 = 0;
  for (int s = 0; s < cpt; ++s) {
    const uint32_t w = static_cast<uint32_t>(tw[s * n + k]);
    for (int c = 0; c < chunks; ++c) {
      const uint32_t rot =
          mulmod(static_cast<uint32_t>(g[(s * chunks + c) * n + k]), w, q, m);
      s0 += mulmod(rot, static_cast<uint32_t>(q0[c * n + k]), q, m);
      s1 += mulmod(rot, static_cast<uint32_t>(q1[c * n + k]), q, m);
    }
  }
  *a0 = reduce40(s0, q, m);
  *a1 = reduce40(s1, q, m);
}

__global__ void fused_rerank_kernel(
    const int32_t* __restrict__ polys, const int32_t* __restrict__ tw,
    const int32_t* __restrict__ f0, const int32_t* __restrict__ f1,
    int32_t* __restrict__ out0, int32_t* __restrict__ out1, int num_ct,
    int cpt, int chunks, int n, uint32_t q, uint64_t m) {
  const int t = blockIdx.x;
  const int b = blockIdx.y;
  const int rows = cpt * chunks;
  const size_t cell = static_cast<size_t>(b) * num_ct + t;
  const int32_t* g = polys + cell * rows * n;
  const int32_t* q0 = f0 + static_cast<size_t>(b) * chunks * n;
  const int32_t* q1 = f1 + static_cast<size_t>(b) * chunks * n;
  const size_t o = cell * n;
  for (int k = threadIdx.x; k < n; k += blockDim.x) {
    uint32_t a0, a1;
    accumulate(g, tw, q0, q1, k, n, cpt, chunks, q, m, &a0, &a1);
    out0[o + k] = static_cast<int32_t>(a0);
    out1[o + k] = static_cast<int32_t>(a1);
  }
}

__global__ void fused_rerank_intt_kernel(
    const int32_t* __restrict__ polys, const int32_t* __restrict__ tw,
    const int32_t* __restrict__ f0, const int32_t* __restrict__ f1,
    const uint32_t* __restrict__ ipsi, int32_t* __restrict__ out0,
    int32_t* __restrict__ out1, int num_ct, int cpt, int chunks, int logn,
    uint32_t q, uint64_t m, uint32_t n_inv) {
  extern __shared__ uint32_t acc[];  // [2][n]
  const int n = 1 << logn;
  const int t = blockIdx.x;
  const int b = blockIdx.y;
  const int rows = cpt * chunks;
  const size_t cell = static_cast<size_t>(b) * num_ct + t;
  const int32_t* g = polys + cell * rows * n;
  const int32_t* q0 = f0 + static_cast<size_t>(b) * chunks * n;
  const int32_t* q1 = f1 + static_cast<size_t>(b) * chunks * n;
  for (int k = threadIdx.x; k < n; k += blockDim.x) {
    accumulate(g, tw, q0, q1, k, n, cpt, chunks, q, m, &acc[k], &acc[n + k]);
  }
  __syncthreads();
  inv_network(acc, 2, logn, ipsi, q, m, n_inv);
  const size_t o = cell * n;
  for (int k = threadIdx.x; k < n; k += blockDim.x) {
    out0[o + k] = static_cast<int32_t>(acc[k]);
    out1[o + k] = static_cast<int32_t>(acc[n + k]);
  }
}

}  // namespace

extern "C" int fused_rerank_intt_launch(
    const void* polys, const void* tw, const void* f0, const void* f1,
    const void* ipsi, void* out0, void* out1, int batch, int num_ct, int cpt,
    int chunks, int n, uint32_t q, uint64_t m, uint32_t n_inv,
    void* stream) {
  if (batch <= 0 || num_ct <= 0) return cudaSuccess;
  const int logn = log2_exact(n);
  const int threads = n < kMaxThreads ? n : kMaxThreads;
  const size_t smem = 2 * static_cast<size_t>(n) * sizeof(uint32_t);
  cudaError_t err = allow_smem(fused_rerank_intt_kernel, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(num_ct, batch);
  fused_rerank_intt_kernel<<<grid, threads, smem,
                             static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(polys), static_cast<const int32_t*>(tw),
      static_cast<const int32_t*>(f0), static_cast<const int32_t*>(f1),
      static_cast<const uint32_t*>(ipsi), static_cast<int32_t*>(out0),
      static_cast<int32_t*>(out1), num_ct, cpt, chunks, logn, q, m, n_inv);
  return cudaGetLastError();
}

extern "C" int fused_rerank_launch(const void* polys, const void* tw,
                                   const void* f0, const void* f1, void* out0,
                                   void* out1, int batch, int num_ct, int cpt,
                                   int chunks, int n, uint32_t q, uint64_t m,
                                   void* stream) {
  if (batch <= 0 || num_ct <= 0) return cudaSuccess;
  const int threads = n < kMaxThreads ? n : kMaxThreads;
  const dim3 grid(num_ct, batch);
  fused_rerank_kernel<<<grid, threads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(polys), static_cast<const int32_t*>(tw),
      static_cast<const int32_t*>(f0), static_cast<const int32_t*>(f1),
      static_cast<int32_t*>(out0), static_cast<int32_t*>(out1), num_ct, cpt,
      chunks, n, q, m);
  return cudaGetLastError();
}

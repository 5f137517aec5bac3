// Modular arithmetic and the negacyclic NTT butterfly networks, shared by
// the standalone NTT kernels (ntt.cu) and the fused re-rank kernel
// (fused.cu), so the fused and staged pipelines run the same integer ops
// and agree bit for bit by construction (as repro/kernels/ntt/fused.py
// reuses ntt.inv_butterflies).
//
// Residues are canonical in [0, q) with q < 2^20.  A product is < 2^40 and
// is reduced with a 64-bit Barrett step: m = floor(2^64 / q), the quotient
// estimate umul64hi(x, m) is floor(x / q) or one less for x < 2^40, so one
// conditional subtraction lands in [0, q).  Canonical residues make any
// exact reduction give the reference's bits.
#pragma once

#include <cstdint>
#include <cuda_runtime.h>

// x mod q for x < 2^40
__device__ __forceinline__ uint32_t reduce40(uint64_t x, uint32_t q,
                                             uint64_t m) {
  const uint64_t est = __umul64hi(x, m);
  const uint32_t r = static_cast<uint32_t>(x - est * q);  // in [0, 2q)
  return r >= q ? r - q : r;
}

__device__ __forceinline__ uint32_t mulmod(uint32_t a, uint32_t b,
                                           uint32_t q, uint64_t m) {
  return reduce40(static_cast<uint64_t>(a) * b, q, m);
}

__device__ __forceinline__ uint32_t addmod(uint32_t a, uint32_t b,
                                           uint32_t q) {
  const uint32_t s = a + b;
  return s >= q ? s - q : s;
}

__device__ __forceinline__ uint32_t submod(uint32_t a, uint32_t b,
                                           uint32_t q) {
  return a >= b ? a - b : a + q - b;
}

// Forward Cooley-Tukey network (merged psi), standard -> bit-reversed
// order, on `rows` polynomials of n = 2^logn coefficients held back to back
// in shared memory.  Stage (m, t): butterfly (i, j) pairs a[i*2t + j] and
// a[i*2t + t + j] with twiddle psi[m + i] — the reference's
// (m, 2, t) reshape.  The caller synchronises before the call; the
// network synchronises after every stage.
__device__ __forceinline__ void fwd_network(uint32_t* a, int rows, int logn,
                                            const uint32_t* __restrict__ psi,
                                            uint32_t q, uint64_t m) {
  const int n = 1 << logn;
  const int half = n >> 1;
  const int total = rows * half;
  for (int mm = 1, logt = logn - 1; mm < n; mm <<= 1, --logt) {
    const int t = 1 << logt;
    for (int k = threadIdx.x; k < total; k += blockDim.x) {
      const int r = k >> (logn - 1);
      const int b = k & (half - 1);
      const int i = b >> logt;
      const int j = b & (t - 1);
      uint32_t* p = a + r * n + (i << (logt + 1)) + j;
      const uint32_t u = p[0];
      const uint32_t v = mulmod(p[t], __ldg(psi + mm + i), q, m);
      p[0] = addmod(u, v, q);
      p[t] = submod(u, v, q);
    }
    __syncthreads();
  }
}

// Inverse Gentleman-Sande network, bit-reversed -> standard order, then the
// N^{-1} scaling; same layout and synchronisation contract as fwd_network.
// Stage (h = m/2, t): butterfly (i, j) with twiddle ipsi[h + i].
__device__ __forceinline__ void inv_network(uint32_t* a, int rows, int logn,
                                            const uint32_t* __restrict__ ipsi,
                                            uint32_t q, uint64_t m,
                                            uint32_t n_inv) {
  const int n = 1 << logn;
  const int half = n >> 1;
  const int total = rows * half;
  for (int h = half, logt = 0; h >= 1; h >>= 1, ++logt) {
    const int t = 1 << logt;
    for (int k = threadIdx.x; k < total; k += blockDim.x) {
      const int r = k >> (logn - 1);
      const int b = k & (half - 1);
      const int i = b >> logt;
      const int j = b & (t - 1);
      uint32_t* p = a + r * n + (i << (logt + 1)) + j;
      const uint32_t u = p[0];
      const uint32_t v = p[t];
      p[0] = addmod(u, v, q);
      p[t] = mulmod(submod(u, v, q), __ldg(ipsi + h + i), q, m);
    }
    __syncthreads();
  }
  for (int k = threadIdx.x; k < rows * n; k += blockDim.x) {
    a[k] = mulmod(a[k], n_inv, q, m);
  }
  __syncthreads();
}

inline int log2_exact(int n) {
  int l = 0;
  while ((1 << l) < n) ++l;
  return l;
}

// Dynamic shared memory above 48 KB needs an opt-in per kernel.
template <typename Kernel>
inline cudaError_t allow_smem(Kernel kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

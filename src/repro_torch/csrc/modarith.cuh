// Modular arithmetic and the inverse NTT butterfly network of the fused
// re-rank kernels (fused.cu), and the Shoup products and lazy butterflies
// of the standalone NTT (ntt.cu).  The fused and staged pipelines agree bit
// for bit because both end in canonical residues, whatever network
// reduced them (repro/kernels/ntt/fused.py reuses ntt.inv_butterflies).
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

// Inverse Gentleman-Sande network, bit-reversed -> standard order, then the
// N^{-1} scaling, on `rows` polynomials of n = 2^logn coefficients held back
// to back in shared memory.  Stage (h = m/2, t): butterfly (i, j) pairs
// a[i*2t + j] and a[i*2t + t + j] with twiddle ipsi[h + i] — the
// reference's (h, 2, t) reshape.  The caller synchronises before the call;
// the network synchronises after every stage.
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

// Shoup products (the standalone NTT, ntt.cu).  For a constant w in [0, q)
// with quotient ws = floor(w * 2^32 / q), t = umulhi(a, ws) is floor(a*w/q)
// or one less for any 32-bit a, so a*w - t*q lies in [0, 2q) and, as
// 2q < 2^21, 32-bit wrapping arithmetic computes it exactly: one high
// multiply, two low ones and a subtraction, no 64-bit product.
__device__ __forceinline__ uint32_t mul_shoup(uint32_t a, uint32_t w,
                                              uint32_t ws, uint32_t q) {
  return a * w - __umulhi(a, ws) * q;
}

__device__ __forceinline__ uint32_t sub_if(uint32_t a, uint32_t b) {
  return a >= b ? a - b : a;
}

// Lazy Cooley-Tukey butterfly (Harvey): x, y in [0, 4q) -> x + yw, x - yw
// in [0, 4q); q2 = 2q.
__device__ __forceinline__ void ct_lazy(uint32_t& x, uint32_t& y, uint32_t w,
                                        uint32_t ws, uint32_t q,
                                        uint32_t q2) {
  const uint32_t u = sub_if(x, q2);
  const uint32_t v = mul_shoup(y, w, ws, q);
  x = u + v;
  y = u - v + q2;
}

// Lazy Gentleman-Sande butterfly: x, y in [0, 2q) -> x + y, (x - y) w in
// [0, 2q).
__device__ __forceinline__ void gs_lazy(uint32_t& x, uint32_t& y, uint32_t w,
                                        uint32_t ws, uint32_t q,
                                        uint32_t q2) {
  const uint32_t s = sub_if(x + y, q2);
  y = mul_shoup(x - y + q2, w, ws, q);
  x = s;
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

// Modular arithmetic of the port's integer kernels: the 64-bit Barrett
// step (pointwise product, the fused re-rank's Hadamard products and sums)
// and the Shoup products and lazy butterflies of the NTT network (ntt.cuh).
//
// Residues are canonical in [0, q) with q < 2^20.  A product is < 2^40 and
// is reduced with a 64-bit Barrett step: m = floor(2^64 / q), the quotient
// estimate umul64hi(x, m) is floor(x / q) or one less, so one conditional
// subtraction lands in [0, q).  Canonical residues make any
// exact reduction give the reference's bits.
#pragma once

#include <cstdint>
#include <cuda_runtime.h>

// x mod q for any 64-bit x: x / q - 2 < umul64hi(x, m) <= x / q, so the
// estimate is floor(x / q) or one less
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

// Shoup products.  For a constant w in [0, q) with quotient
// ws = floor(w * 2^32 / q), t = umulhi(a, ws) is floor(a*w/q) or one less
// for any 32-bit a, so a*w - t*q lies in [0, 2q) and, as 2q < 2^21, 32-bit
// wrapping arithmetic computes it exactly: one high multiply, two low ones
// and a subtraction, no 64-bit product.
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

// Argument blocks of the pointwise product and the RLWE key product
// (csrc/ntt.cu): plain C, shared by the binding (bindings.cpp) and the
// kernels.
#pragma once

#include <cstdint>

// b's leading dims (a's shape, any strides: 0 where b is broadcast),
// size-1 dims dropped and mergeable neighbours merged, innermost first
constexpr int kMaxBcastDims = 4;

struct BcastArgs {
  int64_t size[kMaxBcastDims];
  int64_t stride[kMaxBcastDims];  // in elements
  int dims;
};

// The key product's per-prime scalars, picked by blockIdx.y.
constexpr int kMaxPrimes = 8;

struct KeyMulPrime {
  uint32_t q;
  uint64_t barrett;  // floor(2^64 / q)
  // the inverse NTT's last stage with N^-1 folded in
  uint32_t n_inv, n_inv_shoup, tail_w, tail_ws;
};

struct KeyMulArgs {
  // a: (rows, P, N) int32, row r of prime p at a + r * stride_row +
  // p * stride_prime, N contiguous coefficients
  const void* a;
  int64_t stride_row, stride_prime;
  const void* s;     // (keys, P, N) NTT-domain keys; row r takes r / rows_per_key
  int64_t rows_per_key;
  // (P, N) twiddles and their Shoup quotients, one row per prime
  const void* psi;
  const void* psi_shoup;
  const void* ipsi;
  const void* ipsi_shoup;
  void* out;         // (rows, P, N) contiguous
  int64_t rows;
  int primes, n;
  KeyMulPrime prime[kMaxPrimes];
};

extern "C" int pointwise_mul_launch(const void* a, const void* b, void* out,
                                    int64_t rows, int64_t inner,
                                    const BcastArgs* bcast, uint32_t q,
                                    uint64_t m, void* stream);
extern "C" int key_mul_launch(const KeyMulArgs* args, void* stream);

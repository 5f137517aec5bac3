// Batched negacyclic NTT (forward and inverse) and the pointwise modular
// product, for one RNS prime per launch.
//
// Replaces repro/kernels/ntt/ntt.py: ntt_pallas (forward body _fwd_kernel,
// inverse body _inv_kernel -> inv_butterflies) and pointwise_mul_pallas.
//
// Bound on an H100: bytes.  One NTT reads and writes 4N bytes per
// polynomial and does N/2 * log2(N) butterflies, a handful of integer ops
// per byte.  Design: one block per polynomial, the whole polynomial
// (16 KiB at N = 4096) in shared memory for all log2(N) stages, so device
// memory sees one read and one write per coefficient whatever the stage
// count — the TPU kernel's VMEM-resident tile, one polynomial per block
// instead of a batch tile per grid step.  The pointwise product is a
// grid-stride elementwise pass.

#include "modarith.cuh"

namespace {

constexpr int kMaxThreads = 512;

template <bool kInverse>
__global__ void ntt_kernel(const int32_t* __restrict__ x,
                           int32_t* __restrict__ out,
                           const uint32_t* __restrict__ table, int logn,
                           uint32_t q, uint64_t m, uint32_t n_inv) {
  extern __shared__ uint32_t poly[];
  const int n = 1 << logn;
  const size_t base = static_cast<size_t>(blockIdx.x) * n;
  for (int k = threadIdx.x; k < n; k += blockDim.x) {
    poly[k] = static_cast<uint32_t>(x[base + k]);
  }
  __syncthreads();
  if (kInverse) {
    inv_network(poly, 1, logn, table, q, m, n_inv);
  } else {
    fwd_network(poly, 1, logn, table, q, m);
  }
  for (int k = threadIdx.x; k < n; k += blockDim.x) {
    out[base + k] = static_cast<int32_t>(poly[k]);
  }
}

__global__ void pointwise_kernel(const int32_t* __restrict__ a,
                                 const int32_t* __restrict__ b,
                                 int32_t* __restrict__ out, int64_t count,
                                 uint32_t q, uint64_t m) {
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                   threadIdx.x;
       i < count; i += stride) {
    out[i] = static_cast<int32_t>(mulmod(static_cast<uint32_t>(a[i]),
                                         static_cast<uint32_t>(b[i]), q, m));
  }
}

template <bool kInverse>
int launch_ntt(const void* x, void* out, const void* table, int batch, int n,
               uint32_t q, uint64_t m, uint32_t n_inv, void* stream) {
  if (batch <= 0) return cudaSuccess;
  const int logn = log2_exact(n);
  const int threads = n / 2 < kMaxThreads ? n / 2 : kMaxThreads;
  const size_t smem = static_cast<size_t>(n) * sizeof(uint32_t);
  cudaError_t err = allow_smem(ntt_kernel<kInverse>, smem);
  if (err != cudaSuccess) return err;
  ntt_kernel<kInverse><<<batch, threads, smem,
                         static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(x), static_cast<int32_t*>(out),
      static_cast<const uint32_t*>(table), logn, q, m, n_inv);
  return cudaGetLastError();
}

}  // namespace

extern "C" int ntt_fwd_launch(const void* x, void* out, const void* psi,
                              int batch, int n, uint32_t q, uint64_t m,
                              uint32_t n_inv, void* stream) {
  return launch_ntt<false>(x, out, psi, batch, n, q, m, n_inv, stream);
}

extern "C" int ntt_inv_launch(const void* x, void* out, const void* ipsi,
                              int batch, int n, uint32_t q, uint64_t m,
                              uint32_t n_inv, void* stream) {
  return launch_ntt<true>(x, out, ipsi, batch, n, q, m, n_inv, stream);
}

extern "C" int pointwise_mul_launch(const void* a, const void* b, void* out,
                                    int64_t count, uint32_t q, uint64_t m,
                                    void* stream) {
  if (count <= 0) return cudaSuccess;
  const int threads = 256;
  int64_t blocks = (count + threads - 1) / threads;
  if (blocks > 132 * 32) blocks = 132 * 32;
  pointwise_kernel<<<static_cast<int>(blocks), threads, 0,
                     static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(a), static_cast<const int32_t*>(b),
      static_cast<int32_t*>(out), count, q, m);
  return cudaGetLastError();
}

// Batched negacyclic NTT (forward and inverse) and the pointwise modular
// product, for one RNS prime per launch.
//
// Replaces repro/kernels/ntt/ntt.py: ntt_pallas (forward body _fwd_kernel,
// inverse body _inv_kernel -> inv_butterflies) and pointwise_mul_pallas.
//
// Bound on an H100: bytes at a large batch (one read and one write of 4N
// bytes per polynomial), the latency of the stage chain at batch 1 (most
// launches of the serving path are one polynomial).  The network is the
// register-pass one of ntt.cuh (3 passes and 2 barriers at N = 4096, lazy
// Shoup butterflies, N^-1 folded into the inverse's last stage).  Its first
// pass reads the polynomial from device memory and the last writes it back;
// where a thread's coefficients lie close together (the t < 32 end of the
// network) that access goes through shared memory so it is coalesced.  One
// block of 256 threads per polynomial at N = 4096, four blocks to an SM; for
// small N a block holds several polynomials.
// The pointwise product is a grid-stride elementwise pass (64-bit Barrett,
// modarith.cuh).

#include "ntt.cuh"

namespace {

constexpr int kMinThreads = 256;

// blockDim = (N / E, polynomials per block); one polynomial per y.  A block
// past the batch's end reads polynomial 0 and writes nothing.
// kMaxThreads and kMinBlocks (per SM) set the compiler's register budget.
template <int LOGN, bool kInverse, int kMaxThreads, int kMinBlocks>
__global__ void __launch_bounds__(kMaxThreads, kMinBlocks)
ntt_kernel(const int32_t* __restrict__ x, int32_t* __restrict__ out,
           const uint32_t* __restrict__ tw, const uint32_t* __restrict__ tws,
           int64_t batch, uint32_t q, InvTail tail) {
  using T = Ntt<LOGN, kInverse>;
  extern __shared__ uint32_t smem[];
  const int64_t poly = static_cast<int64_t>(blockIdx.x) * blockDim.y +
                       threadIdx.y;
  const bool live = poly < batch;
  const int64_t off = live ? poly * T::N : 0;
  uint32_t v[T::E];
  T::template pass<0>(v, x + off, out + off, smem + threadIdx.y * pad(T::N),
                      live, tw, tws, q, tail);
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

// Up to N = 4096 a block has 256 threads and four blocks share an SM (64
// registers a thread); N = 8192 and 16384 take 512 and 1024 threads.
template <int LOGN, bool kInverse>
cudaError_t launch_n(const int32_t* x, int32_t* out, const uint32_t* tw,
                     const uint32_t* tws, int64_t batch, uint32_t q,
                     InvTail tail, cudaStream_t stream) {
  using T = Ntt<LOGN, kInverse>;
  constexpr bool kSmall = T::TPP <= kMinThreads;
  constexpr int kPpb = T::TPP >= kMinThreads ? 1 : kMinThreads / T::TPP;
  auto* kernel = ntt_kernel<LOGN, kInverse, kSmall ? kMinThreads : 1024,
                            kSmall ? 4 : 1>;
  const int64_t blocks = (batch + kPpb - 1) / kPpb;
  if (blocks > INT32_MAX) return cudaErrorInvalidValue;
  const size_t smem = sizeof(uint32_t) * kPpb * pad(T::N);
  const cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  kernel<<<static_cast<int>(blocks), dim3(T::TPP, kPpb), smem, stream>>>(
      x, out, tw, tws, batch, q, tail);
  return cudaGetLastError();
}

template <bool kInverse, int LOGN = 1>
cudaError_t launch_logn(int logn, const int32_t* x, int32_t* out,
                        const uint32_t* tw, const uint32_t* tws, int64_t batch,
                        uint32_t q, InvTail tail, cudaStream_t stream) {
  if (logn == LOGN) {
    return launch_n<LOGN, kInverse>(x, out, tw, tws, batch, q, tail, stream);
  }
  if constexpr (LOGN < 14) {
    return launch_logn<kInverse, LOGN + 1>(logn, x, out, tw, tws, batch, q,
                                           tail, stream);
  }
  return cudaErrorInvalidValue;
}

template <bool kInverse>
int launch_ntt(const void* x, void* out, const void* table,
               const void* table_shoup, int64_t batch, int n, uint32_t q,
               InvTail tail, void* stream) {
  if (batch <= 0) return cudaSuccess;
  return launch_logn<kInverse>(
      log2_exact(n), static_cast<const int32_t*>(x), static_cast<int32_t*>(out),
      static_cast<const uint32_t*>(table),
      static_cast<const uint32_t*>(table_shoup), batch, q, tail,
      static_cast<cudaStream_t>(stream));
}

}  // namespace

extern "C" int ntt_fwd_launch(const void* x, void* out, const void* psi,
                              const void* psi_shoup, int64_t batch, int n,
                              uint32_t q, void* stream) {
  return launch_ntt<false>(x, out, psi, psi_shoup, batch, n, q, InvTail{},
                           stream);
}

extern "C" int ntt_inv_launch(const void* x, void* out, const void* ipsi,
                              const void* ipsi_shoup, int64_t batch, int n,
                              uint32_t q, uint32_t n_inv, uint32_t n_inv_s,
                              uint32_t tail_w, uint32_t tail_ws,
                              void* stream) {
  return launch_ntt<true>(x, out, ipsi, ipsi_shoup, batch, n, q,
                          InvTail{n_inv, n_inv_s, tail_w, tail_ws}, stream);
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

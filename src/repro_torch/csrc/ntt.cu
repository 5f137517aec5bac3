// Batched negacyclic NTT (forward and inverse) for one RNS prime per
// launch, the pointwise modular product, and the RLWE key product
// iNTT(NTT(a) * s) for every prime in one launch.
//
// Replaces repro/kernels/ntt/ntt.py: ntt_pallas (forward body _fwd_kernel,
// inverse body _inv_kernel -> inv_butterflies) and pointwise_mul_pallas;
// the key product fuses the chain ntt_pallas -> pointwise_mul_pallas ->
// ntt_pallas(inverse) that the reference's encrypt_query and decrypt_rns
// run prime by prime.
//
// NTT.  Bound on an H100: bytes at a large batch (one read and one write of
// 4N bytes per polynomial), the latency of the stage chain at batch 1 (most
// launches of the serving path are one polynomial).  The network is the
// register-pass one of ntt.cuh (3 passes and 2 barriers at N = 4096, lazy
// Shoup butterflies, N^-1 folded into the inverse's last stage).  Its first
// pass reads the polynomial from device memory and the last writes it back;
// where a thread's coefficients lie close together (the t < 32 end of the
// network) that access goes through shared memory so it is coalesced.  One
// block of 256 threads per polynomial at N = 4096, four blocks to an SM; for
// small N a block holds several polynomials.
//
// Pointwise product.  Bound: bytes.  Each thread multiplies VW = 4 (2, 1
// when the row length is not a multiple) residues with 16-byte loads and
// stores, one thread per vector, the grid sized to the work; b is read
// through its own strides (keymul.h: 0 where it is broadcast), so a key row
// expanded over a batch is read from one row, not from a copy.  64-bit
// Barrett step (modarith.cuh).
//
// Key product.  Bound: bytes (the polynomial in and out, the key).  Grid
// (row blocks, P): blockIdx.y picks the prime's tables, scalars and key
// row; a block runs the forward network of ntt.cuh with the polynomial
// left in shared memory (kToShared: no round trip through device memory),
// multiplies it by the key read coalesced (the forward's lazy [0, 4q)
// values go into the Barrett step as they are, whose result is canonical),
// and runs the inverse network from shared memory, as the fused re-rank
// does after its Phase A.  `a` is read in place through its row and prime
// strides; the same shared memory (pad(N) words a polynomial) and block
// shape as the standalone NTT.

#include "keymul.h"
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

template <int J>
__device__ __forceinline__ void store_run(int32_t* dst, const uint32_t* v) {
  if constexpr (J == 4) {
    *reinterpret_cast<int4*>(dst) = make_int4(v[0], v[1], v[2], v[3]);
  } else if constexpr (J == 2) {
    *reinterpret_cast<int2*>(dst) = make_int2(v[0], v[1]);
  } else {
    dst[0] = static_cast<int32_t>(v[0]);
  }
}

constexpr int kPointwiseThreads = 256;

// One thread per VW-residue vector of a (rows of `cols` vectors,
// contiguous); b's offset for the vector's row from b's collapsed leading
// dims (keymul.h), the outermost without a division.
template <int VW>
__global__ void __launch_bounds__(kPointwiseThreads)
pointwise_kernel(const int32_t* __restrict__ a, const int32_t* __restrict__ b,
                 int32_t* __restrict__ out, uint32_t vecs, uint32_t cols,
                 const BcastArgs bc, uint32_t q, uint64_t m) {
  const uint32_t i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= vecs) return;
  const uint32_t row = i / cols;
  const uint32_t col = (i - row * cols) * VW;
  uint32_t rem = row;
  int64_t off = col;
#pragma unroll
  for (int d = 0; d < kMaxBcastDims; ++d) {
    if (d + 1 < bc.dims) {
      const uint32_t size = static_cast<uint32_t>(bc.size[d]);
      const uint32_t next = rem / size;
      off += static_cast<int64_t>(rem - next * size) * bc.stride[d];
      rem = next;
    } else if (d + 1 == bc.dims) {
      off += static_cast<int64_t>(rem) * bc.stride[d];
    }
  }
  uint32_t x[VW], y[VW];
  load_run<VW>(x, reinterpret_cast<const uint32_t*>(a) +
                      static_cast<size_t>(i) * VW);
  load_run<VW>(y, reinterpret_cast<const uint32_t*>(b) + off);
#pragma unroll
  for (int k = 0; k < VW; ++k) x[k] = mulmod(x[k], y[k], q, m);
  store_run<VW>(out + static_cast<size_t>(i) * VW, x);
}

// blockDim = (N / E, polynomials per block), grid (row blocks, P).  A
// polynomial slot past the last row computes row 0 and writes nothing (it
// takes part in the barriers).
template <int LOGN, int kMaxThreads, int kMinBlocks>
__global__ void __launch_bounds__(kMaxThreads, kMinBlocks)
key_mul_kernel(const KeyMulArgs args) {
  using Fwd = Ntt<LOGN, false, false, true>;
  using Inv = Ntt<LOGN, true, true>;
  constexpr int N = Fwd::N;
  constexpr int VW = Fwd::E < 4 ? Fwd::E : 4;
  constexpr int NV = Fwd::E / VW;
  extern __shared__ uint32_t smem[];
  // the prime's scalars with constant indices only (a dynamic index into
  // the parameter block would copy it to local memory)
  const int p = blockIdx.y;
  KeyMulPrime c = args.prime[0];
#pragma unroll
  for (int i = 1; i < kMaxPrimes; ++i) {
    if (i == p) c = args.prime[i];
  }
  const InvTail tail{c.n_inv, c.n_inv_shoup, c.tail_w, c.tail_ws};
  const int64_t poly = static_cast<int64_t>(blockIdx.x) * blockDim.y +
                       threadIdx.y;
  const bool live = poly < args.rows;
  const int64_t r = live ? poly : 0;
  const int32_t* src = static_cast<const int32_t*>(args.a) +
                       r * args.stride_row + p * args.stride_prime;
  int32_t* dst = static_cast<int32_t*>(args.out) +
                 (r * args.primes + p) * static_cast<int64_t>(N);
  const uint32_t* key = static_cast<const uint32_t*>(args.s) +
                        ((r / args.rows_per_key) * args.primes + p) *
                            static_cast<int64_t>(N);
  const size_t t = static_cast<size_t>(p) * N;
  uint32_t* sp = smem + threadIdx.y * pad(N);
  uint32_t v[Fwd::E];
  Fwd::template pass<0>(v, src, nullptr, sp, live,
                        static_cast<const uint32_t*>(args.psi) + t,
                        static_cast<const uint32_t*>(args.psi_shoup) + t, c.q,
                        tail);
  __syncthreads();
#pragma unroll
  for (int j = 0; j < NV; ++j) {
    const int k = (threadIdx.x + j * Fwd::TPP) * VW;
    uint32_t w[VW];
    load_run<VW>(w, key + k);
    uint32_t* x = sp + pad(k);  // k % VW == 0: one 32-word line
#pragma unroll
    for (int i = 0; i < VW; ++i) x[i] = mulmod(x[i], w[i], c.q, c.barrett);
  }
  __syncthreads();
  Inv::template pass<0>(v, nullptr, dst, sp, live,
                        static_cast<const uint32_t*>(args.ipsi) + t,
                        static_cast<const uint32_t*>(args.ipsi_shoup) + t,
                        c.q, tail);
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

// The standalone NTT's block shape and register budget.
template <int LOGN>
cudaError_t key_mul_n(const KeyMulArgs& a, cudaStream_t stream) {
  using T = Ntt<LOGN, false>;
  constexpr bool kSmall = T::TPP <= kMinThreads;
  constexpr int kPpb = T::TPP >= kMinThreads ? 1 : kMinThreads / T::TPP;
  auto* kernel = key_mul_kernel<LOGN, kSmall ? kMinThreads : 1024,
                                kSmall ? 4 : 1>;
  const int64_t blocks = (a.rows + kPpb - 1) / kPpb;
  if (blocks > INT32_MAX) return cudaErrorInvalidValue;
  const size_t smem = sizeof(uint32_t) * kPpb * pad(T::N);
  const cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  kernel<<<dim3(static_cast<unsigned>(blocks), a.primes), dim3(T::TPP, kPpb),
           smem, stream>>>(a);
  return cudaGetLastError();
}

template <int LOGN = 1>
cudaError_t key_mul_logn(int logn, const KeyMulArgs& a, cudaStream_t stream) {
  if (logn == LOGN) return key_mul_n<LOGN>(a, stream);
  if constexpr (LOGN < 14) return key_mul_logn<LOGN + 1>(logn, a, stream);
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
                                    int64_t rows, int64_t inner,
                                    const BcastArgs* bcast, uint32_t q,
                                    uint64_t m, void* stream) {
  if (rows <= 0 || inner <= 0) return cudaSuccess;
  const int vw = inner % 4 == 0 ? 4 : inner % 2 == 0 ? 2 : 1;
  const int64_t vecs = rows * inner / vw;
  if (vecs > UINT32_MAX) return cudaErrorInvalidValue;
  const unsigned blocks = static_cast<unsigned>(
      (vecs + kPointwiseThreads - 1) / kPointwiseThreads);
  const auto s = static_cast<cudaStream_t>(stream);
  const auto* pa = static_cast<const int32_t*>(a);
  const auto* pb = static_cast<const int32_t*>(b);
  auto* po = static_cast<int32_t*>(out);
  const auto nv = static_cast<uint32_t>(vecs);
  const auto cols = static_cast<uint32_t>(inner / vw);
  if (vw == 4) {
    pointwise_kernel<4><<<blocks, kPointwiseThreads, 0, s>>>(
        pa, pb, po, nv, cols, *bcast, q, m);
  } else if (vw == 2) {
    pointwise_kernel<2><<<blocks, kPointwiseThreads, 0, s>>>(
        pa, pb, po, nv, cols, *bcast, q, m);
  } else {
    pointwise_kernel<1><<<blocks, kPointwiseThreads, 0, s>>>(
        pa, pb, po, nv, cols, *bcast, q, m);
  }
  return cudaGetLastError();
}

extern "C" int key_mul_launch(const KeyMulArgs* args, void* stream) {
  if (args->rows <= 0) return cudaSuccess;
  if (args->primes < 1 || args->primes > kMaxPrimes || args->primes > 65535) {
    return cudaErrorInvalidValue;
  }
  return key_mul_logn(log2_exact(args->n), *args,
                      static_cast<cudaStream_t>(stream));
}

// Batched negacyclic NTT (forward and inverse) and the pointwise modular
// product, for one RNS prime per launch.
//
// Replaces repro/kernels/ntt/ntt.py: ntt_pallas (forward body _fwd_kernel,
// inverse body _inv_kernel -> inv_butterflies) and pointwise_mul_pallas.
//
// Bound on an H100: bytes at a large batch (one read and one write of 4N
// bytes per polynomial), the latency of the stage chain at batch 1 (most
// launches of the serving path are one polynomial).  Design:
//   * each thread holds E = 16 coefficients (fewer for N < 16) in registers
//     and runs up to log2(E) butterfly stages there before the block
//     exchanges them through shared memory: at N = 4096 the 12 stages take
//     3 passes (the network of modarith.cuh has a barrier after each of its
//     12 stages, plus a 13th pass for N^-1).  The first pass reads the
//     polynomial from device memory and the last writes it back; where a
//     thread's coefficients lie close together (the t < 32 end of the
//     network) that access goes through shared memory so it is coalesced;
//     one pad word every 32 spreads the strided passes over the banks;
//   * every product is a Shoup product with a precomputed quotient per
//     twiddle (`*_shoup` tables), 32-bit only; values stay lazily in
//     [0, 4q) (forward) or [0, 2q) (inverse) between stages and are reduced
//     to canonical residues once, when written, so the output equals the
//     reference's bits;
//   * a pass loads its twiddles (one aligned run per stage, as 16-byte
//     vectors) together with its coefficients, so the latencies overlap;
//   * the inverse folds N^-1 into its last stage: (u + v) N^-1 and
//     (u - v)(psi^-1 N^-1), each with its Shoup pair;
//   * the pass schedule is a compile-time function of N (one kernel per
//     N), so every shared-memory and device offset is an immediate;
//   * one block of 256 threads per polynomial at N = 4096, four blocks to
//     an SM; for small N a block holds several polynomials.
// The pointwise product is a grid-stride elementwise pass (64-bit Barrett,
// modarith.cuh).

#include "modarith.cuh"

namespace {

constexpr int kMaxLogE = 4;
constexpr int kMinThreads = 256;

// shared-memory slot of coefficient i: one pad word after every 32
__host__ __device__ __forceinline__ int pad(int i) { return i + (i >> 5); }

struct InvTail {  // inverse NTT's last stage with N^-1 folded in
  uint32_t n_inv, n_inv_s, w, ws;
};

// dst[0..J) = src[0..J), src aligned to min(J, 4) words
template <int J>
__device__ __forceinline__ void load_run(uint32_t* dst, const uint32_t* src) {
  if constexpr (J >= 4) {
#pragma unroll
    for (int i = 0; i < J; i += 4) {
      const uint4 v = __ldg(reinterpret_cast<const uint4*>(src + i));
      dst[i] = v.x;
      dst[i + 1] = v.y;
      dst[i + 2] = v.z;
      dst[i + 3] = v.w;
    }
  } else if constexpr (J == 2) {
    const uint2 v = __ldg(reinterpret_cast<const uint2*>(src));
    dst[0] = v.x;
    dst[1] = v.y;
  } else {
    dst[0] = __ldg(src);
  }
}

// One group of 2^S coefficients g[k] = a[b + k*tmin] (tmin = 2^lt) through
// stages L..S-1 of a pass.  Forward stage l (t = tmin << (S-1-l)) pairs k0
// and k0 + 2^(S-1-l); inverse stage l (t = tmin << l) pairs k0 and
// k0 + 2^l.  The pairs with k0 = j * 2 * half + r share one twiddle,
// ((N + b) >> sh) + j with sh = log2(2t) (b has zero bits where j * 2t
// lands): 2^S - 1 twiddles per group, loaded by `twiddles` in stage order
// before the first stage.  Stages are template-recursive so that every
// register index is a compile-time constant.
template <int S, bool kInverse, int L = 0>
struct GroupStages {
  static constexpr int kHalf = kInverse ? 1 << L : 1 << (S - 1 - L);
  static constexpr int kJ = (1 << S) / (2 * kHalf);     // twiddles
  static constexpr int kC = kInverse ? (1 << S) - (1 << (S - L))
                                     : (1 << L) - 1;    // first one's slot

  __device__ __forceinline__ static void twiddles(uint32_t* w, uint32_t* ws,
                                                  int b, int lt, int n,
                                                  const uint32_t* tw,
                                                  const uint32_t* tws) {
    // t0 is a multiple of kJ (b >> sh is), so the stage's kJ twiddles are
    // one aligned run: read as 16-, 8- or 4-byte vectors
    const int t0 = (n + b) >> (kInverse ? lt + L + 1 : lt + S - L);
    load_run<kJ>(w + kC, tw + t0);
    load_run<kJ>(ws + kC, tws + t0);
    if constexpr (L + 1 < S) {
      GroupStages<S, kInverse, L + 1>::twiddles(w, ws, b, lt, n, tw, tws);
    }
  }

  // `fold`: the group's last stage is the inverse network's last one,
  // with the N^-1-folded pair in place of its twiddle
  __device__ __forceinline__ static void run(uint32_t* g, const uint32_t* w,
                                             const uint32_t* ws, uint32_t q,
                                             bool fold, const InvTail& tail) {
    const uint32_t q2 = 2 * q;
#pragma unroll
    for (int j = 0; j < kJ; ++j) {
#pragma unroll
      for (int r = 0; r < kHalf; ++r) {
        uint32_t& x = g[j * 2 * kHalf + r];
        uint32_t& y = g[j * 2 * kHalf + r + kHalf];
        if (kInverse && L == S - 1 && fold) {
          const uint32_t s = mul_shoup(x + y, tail.n_inv, tail.n_inv_s, q);
          y = mul_shoup(x - y + q2, tail.w, tail.ws, q);
          x = s;
        } else if (kInverse) {
          gs_lazy(x, y, w[kC + j], ws[kC + j], q, q2);
        } else {
          ct_lazy(x, y, w[kC + j], ws[kC + j], q, q2);
        }
      }
    }
    if constexpr (L + 1 < S) {
      GroupStages<S, kInverse, L + 1>::run(g, w, ws, q, fold, tail);
    }
  }
};

// In `Ntt::pass`, a thread's shared-memory slots are pad(base) plus
// compile-time offsets: for an offset `off` (a multiple of a unit that
// divides 32 or that 32 divides) and base % 32 below that unit, base + off
// crosses no more 32-word lines than off does, so
// pad(base + off) = pad(base) + slot(off).
__host__ __device__ constexpr int slot(int off) { return off + (off >> 5); }

// The transform of one N = 2^LOGN polynomial by TPP = N / E threads, each
// holding E coefficients in v: PASSES passes of up to LOGE stages, every
// index and flag a compile-time constant except the thread's own.
template <int LOGN, bool kInverse>
struct Ntt {
  static constexpr int LOGE = LOGN < kMaxLogE ? LOGN : kMaxLogE;
  static constexpr int E = 1 << LOGE;
  static constexpr int N = 1 << LOGN;
  static constexpr int TPP = N >> LOGE;
  static constexpr int FULL = LOGN / LOGE;
  static constexpr int PASSES = FULL + (LOGN % LOGE > 0);

  // Pass P: S stages, each thread on G = 2^(LOGE - S) groups of K = 2^S
  // coefficients a[base + k * TMIN].  The first pass reads device memory,
  // the last writes it (canonical residues); the others read and write
  // shared memory.  A first or last pass whose groups are narrower than a
  // warp's 32 words (TMIN < 32: each thread's coefficients lie close
  // together) moves device memory through shared memory instead, so every
  // device access is coalesced.  The pass's twiddles and coefficients are
  // loaded together before its first stage, so their latencies overlap.
  template <int P>
  __device__ __forceinline__ static void pass(
      uint32_t (&v)[E], const int32_t* __restrict__ src,
      int32_t* __restrict__ dst, uint32_t* sp, bool live, const uint32_t* tw,
      const uint32_t* tws, uint32_t q, const InvTail& tail) {
    constexpr int S = P < FULL ? LOGE : LOGN % LOGE;
    constexpr int K = 1 << S;
    constexpr int G = 1 << (LOGE - S);
    constexpr bool kFirst = P == 0;
    constexpr bool kLast = P == PASSES - 1;
    constexpr int LT = kInverse ? P * LOGE : LOGN - P * LOGE - S;
    constexpr int TMIN = 1 << LT;
    constexpr bool kStaged = LT < 5;
    const int tid = threadIdx.x;
    if constexpr (kFirst && kStaged) {  // coalesced device -> shared
      uint32_t c[E];
#pragma unroll
      for (int k = 0; k < E; ++k) {
        c[k] = static_cast<uint32_t>(__ldg(src + tid + k * TPP));
      }
      uint32_t* p = sp + pad(tid);
#pragma unroll
      for (int k = 0; k < E; ++k) p[slot(k * TPP)] = c[k];
      __syncthreads();
    }
    int base[G];
#pragma unroll
    for (int h = 0; h < G; ++h) {
      const int gi = tid + h * TPP;
      base[h] = ((gi >> LT) << (LT + S)) | (gi & (TMIN - 1));
    }
    uint32_t w[G * (K - 1)], ws[G * (K - 1)];
#pragma unroll
    for (int h = 0; h < G; ++h) {
      GroupStages<S, kInverse>::twiddles(w + h * (K - 1), ws + h * (K - 1),
                                         base[h], LT, N, tw, tws);
    }
#pragma unroll
    for (int h = 0; h < G; ++h) {
      uint32_t* p = sp + pad(base[h]);
#pragma unroll
      for (int k = 0; k < K; ++k) {
        v[h * K + k] =
            (!kFirst || kStaged)
                ? p[slot(k * TMIN)]
                : static_cast<uint32_t>(__ldg(src + base[h] + k * TMIN));
      }
    }
#pragma unroll
    for (int h = 0; h < G; ++h) {
      GroupStages<S, kInverse>::run(v + h * K, w + h * (K - 1),
                                    ws + h * (K - 1), q, kLast, tail);
    }
#pragma unroll
    for (int h = 0; h < G; ++h) {
      uint32_t* p = sp + pad(base[h]);
#pragma unroll
      for (int k = 0; k < K; ++k) {
        uint32_t x = v[h * K + k];
        if constexpr (kLast) {
          if (!kInverse) x = sub_if(x, 2 * q);
          x = sub_if(x, q);
        }
        if constexpr (!kLast || kStaged) {
          p[slot(k * TMIN)] = x;
        } else {
          if (live) dst[base[h] + k * TMIN] = static_cast<int32_t>(x);
        }
      }
    }
    if constexpr (kLast && kStaged) {  // coalesced shared -> device
      __syncthreads();
      const uint32_t* p = sp + pad(tid);
      if (live) {
#pragma unroll
        for (int k = 0; k < E; ++k) {
          dst[tid + k * TPP] = static_cast<int32_t>(p[slot(k * TPP)]);
        }
      }
    }
    if constexpr (!kLast) {
      __syncthreads();
      pass<P + 1>(v, src, dst, sp, live, tw, tws, q, tail);
    }
  }
};

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

// The register-pass negacyclic NTT network, shared by the standalone NTT
// (ntt.cu) and the fused re-rank kernels (fused.cu).
//
// A thread holds E = 16 coefficients (fewer for N < 16) in registers and
// runs up to log2(E) butterfly stages there before the block exchanges them
// through shared memory: at N = 4096 the 12 stages take 3 passes and 2
// barriers.  Every product is a Shoup product with a precomputed quotient
// per twiddle; values stay lazily in [0, 4q) (forward) or [0, 2q) (inverse)
// between stages and are reduced to canonical residues once, when written,
// so any caller's output equals the reference's bits.  The inverse folds
// N^-1 into its last stage.  The pass schedule is a compile-time function
// of N, so every shared-memory and device offset is an immediate.
#pragma once

#include "modarith.cuh"

namespace {

constexpr int kMaxLogE = 4;

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
// kFromShared: the caller has written the polynomial to shared memory in the
// padded layout (coefficient i at pad(i)) and synchronised, so the first
// pass reads it there instead of from device memory (`src` is unused).
// kToShared: the last pass leaves the polynomial in shared memory in that
// layout, lazy (forward: in [0, 4q)), instead of writing canonical residues
// to device memory (`dst` is unused); the caller synchronises before it
// reads them and reduces them itself.
template <int LOGN, bool kInverse, bool kFromShared = false,
          bool kToShared = false>
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
    if constexpr (kFirst && kStaged && !kFromShared) {  // coalesced load
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
            (!kFirst || kStaged || kFromShared)
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
        if constexpr (kLast && !kToShared) {
          if (!kInverse) x = sub_if(x, 2 * q);
          x = sub_if(x, q);
        }
        if constexpr (!kLast || kStaged || kToShared) {
          p[slot(k * TMIN)] = x;
        } else {
          if (live) dst[base[h] + k * TMIN] = static_cast<int32_t>(x);
        }
      }
    }
    if constexpr (kLast && kStaged && !kToShared) {  // shared -> device
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

}  // namespace

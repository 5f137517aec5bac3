// Fused cached re-rank for one RNS prime: slot-twiddle rotate ->
// Hadamard against both query components -> slot/chunk sum with one
// reduction, optionally followed by the inverse NTT, in one kernel.
//
// Replaces repro/kernels/ntt/fused.py:
//   fused_rerank_intt_pallas  (body _fused_intt_kernel -> _accumulate, then
//                             ntt.inv_butterflies): the serving hot kernel;
//   fused_rerank_pallas       (body _fused_kernel -> _accumulate): the
//                             NTT-domain accumulator pair out — the staged
//                             variant, off the serving path.
//
// Per (lane b, result ciphertext t), for every coefficient k:
//   acc_z[k] = sum_{s < cpt, t*cpt + s < num_cands} sum_{c < chunks}
//                (rows[b, t*cpt + s, c, k] * tw[s, k] mod q)
//                * f_z[b, c, k] mod q,          z in {0, 1}
// The reference sums the canonical products raw in 32 bits and reduces
// once (the binding checks cpt * chunks * (q - 1) < 2^31, as the reference
// asserts).  Here, since f_z[b, c, k] is the same for every slot, the
// canonical rotates of a chunk are summed raw (below cpt * q) and reduced,
// then multiplied by f_z once, and the chunks' canonical products summed
// raw and reduced once: the same residue, so the same canonical bits, with
// one Hadamard product per chunk instead of one per slot.  The rows are
// read in place through their strides (fused.h): the gathered cache rows
// (B, nc, chunks, P, N) at one prime, or a (B, num_ct, cpt * chunks, N)
// tensor.  Slots at or past num_cands (the last result ciphertext's empty
// ones) contribute nothing, as the reference's zero padding does.
//
// Bound on an H100: bytes (each row read once, two rows written per cell).
// Design:
//   * Phase A: each thread reads 16-byte vectors of the rows, the twiddle
//     row, its Shoup quotients (the caches build the table with their
//     twiddles) and the query rows, four slots as straight-line code so
//     their loads are in flight together; the rotate is a Shoup product,
//     the Hadamard product a 64-bit Barrett step;
//   * intt: Phase A writes the reduced sums to shared memory in the padded
//     layout of ntt.cuh, and Phase B is that file's register-pass inverse
//     network (3 passes and 2 barriers at N = 4096, N^-1 folded into the
//     last stage, canonical residues written coalesced).  The staged
//     kernel writes Phase A's sums with vector stores.  Both end in
//     canonical residues, so staged + the standalone inverse NTT (the same
//     network) equals the fused kernel bit for bit;
//   * one block per (cell, component), the two blocks of a cell adjacent
//     in the grid, each computing the rotate (the second read of the rows
//     hits L2): 256 threads at N = 4096.  Keeping a cell's pair in one
//     block to share the rotate measured slower at B = 1 and level at
//     B = 8 (PERF.md).

#include "fused.h"
#include "ntt.cuh"

namespace {

constexpr int kSlots = 4;  // slots of a result ciphertext unrolled together

__device__ __forceinline__ const uint32_t* u32(const void* p) {
  return static_cast<const uint32_t*>(p);
}

// Phase A of one block: the reduced sums of component z at the thread's
// coefficients, to shared memory (intt, padded layout of ntt.cuh) or to
// `out` (staged).  The block's TPP threads share the N coefficients.
template <int LOGN, bool kIntt>
__device__ __forceinline__ void accumulate(const FusedArgs& a, uint32_t* smem,
                                           int32_t* out, int t, int b, int z) {
  using T = Ntt<LOGN, true, true>;
  constexpr int N = T::N;
  constexpr int VW = T::E < 4 ? T::E : 4;
  constexpr int NV = T::E / VW;
  const uint32_t q = a.q;
  const uint64_t m = a.barrett;
  const int live = min(a.cpt, a.num_cands - t * a.cpt);  // >= 1
  const uint32_t* rows = u32(a.rows) + b * a.stride_b +
                         static_cast<int64_t>(t) * a.cpt * a.stride_cand;
  const uint32_t* fz =
      u32(z == 0 ? a.f0 : a.f1) + static_cast<size_t>(b) * a.chunks * N;

#pragma unroll
  for (int j = 0; j < NV; ++j) {
    const int k = (threadIdx.x + j * T::TPP) * VW;
    uint32_t acc[VW] = {};
    for (int c = 0; c < a.chunks; ++c) {
      uint32_t f[VW];
      load_run<VW>(f, fz + c * N + k);
      // kSlots slots at a time as straight-line code: a slot past `live`
      // reads slot live - 1 again (in bounds) and adds nothing
      const uint32_t* rc = rows + c * a.stride_chunk + k;
      uint32_t sum[VW] = {};
      for (int s0 = 0; s0 < live; s0 += kSlots) {
#pragma unroll
        for (int ds = 0; ds < kSlots; ++ds) {
          const int s = min(s0 + ds, live - 1);
          const bool on = s0 + ds < live;
          uint32_t g[VW], w[VW], ws[VW];
          load_run<VW>(g, rc + s * a.stride_cand);
          load_run<VW>(w, u32(a.tw) + s * N + k);
          load_run<VW>(ws, u32(a.tw_shoup) + s * N + k);
#pragma unroll
          for (int i = 0; i < VW; ++i) {
            const uint32_t rot = sub_if(mul_shoup(g[i], w[i], ws[i], q), q);
            sum[i] += on ? rot : 0;
          }
        }
      }
#pragma unroll
      for (int i = 0; i < VW; ++i) {
        acc[i] += mulmod(reduce40(sum[i], q, m), f[i], q, m);
      }
    }
    uint32_t r[VW];
#pragma unroll
    for (int i = 0; i < VW; ++i) r[i] = reduce40(acc[i], q, m);
    if constexpr (kIntt) {
      uint32_t* p = smem + pad(k);  // k % VW == 0: one 32-word line
#pragma unroll
      for (int i = 0; i < VW; ++i) p[i] = r[i];
    } else if constexpr (VW == 4) {
      *reinterpret_cast<int4*>(out + k) = make_int4(r[0], r[1], r[2], r[3]);
    } else if constexpr (VW == 2) {
      *reinterpret_cast<int2*>(out + k) = make_int2(r[0], r[1]);
    } else {
      out[k] = static_cast<int32_t>(r[0]);
    }
  }
}

// blockDim = N / E; blockIdx.x = 2 * t + z (component fastest),
// blockIdx.y = lane.
template <int LOGN, bool kIntt, int kMinBlocks>
__global__ void __launch_bounds__(Ntt<LOGN, true, true>::TPP, kMinBlocks)
fused_kernel(const FusedArgs a) {
  using T = Ntt<LOGN, true, true>;
  extern __shared__ uint32_t smem[];  // pad(N) words, intt only
  const int t = blockIdx.x >> 1;
  const int z = blockIdx.x & 1;
  const int b = blockIdx.y;
  int32_t* out = static_cast<int32_t*>(z == 0 ? a.out0 : a.out1) +
                 (static_cast<size_t>(b) * a.num_ct + t) * T::N;
  accumulate<LOGN, kIntt>(a, smem, out, t, b, z);
  if constexpr (kIntt) {
    __syncthreads();
    const InvTail tail{a.n_inv, a.n_inv_shoup, a.tail_w, a.tail_ws};
    uint32_t v[T::E];
    T::template pass<0>(v, nullptr, out, smem, true, u32(a.ipsi),
                        u32(a.ipsi_shoup), a.q, tail);
  }
}

// Register budget: 64 a thread (1024 threads an SM), as the NTT's.
template <int LOGN, bool kIntt>
cudaError_t launch(const FusedArgs& a, cudaStream_t stream) {
  using T = Ntt<LOGN, true, true>;
  constexpr int kMinBlocks = T::TPP >= 1024 ? 1
                             : 1024 / T::TPP > 32 ? 32
                                                  : 1024 / T::TPP;
  auto* kernel = fused_kernel<LOGN, kIntt, kMinBlocks>;
  const size_t smem = kIntt ? sizeof(uint32_t) * pad(T::N) : 0;
  const cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  const int64_t gx = 2 * static_cast<int64_t>(a.num_ct);
  if (gx > INT32_MAX) return cudaErrorInvalidValue;
  kernel<<<dim3(static_cast<unsigned>(gx), a.batch), T::TPP, smem, stream>>>(
      a);
  return cudaGetLastError();
}

template <bool kIntt, int LOGN = 1>
cudaError_t launch_logn(int logn, const FusedArgs& a, cudaStream_t stream) {
  if (logn == LOGN) return launch<LOGN, kIntt>(a, stream);
  if constexpr (LOGN < 14) {
    return launch_logn<kIntt, LOGN + 1>(logn, a, stream);
  }
  return cudaErrorInvalidValue;
}

}  // namespace

extern "C" int fused_rerank_launch(const FusedArgs* args, void* stream) {
  if (args->batch <= 0 || args->num_ct <= 0) return cudaSuccess;
  const int logn = log2_exact(args->n);
  const auto s = static_cast<cudaStream_t>(stream);
  return args->intt ? launch_logn<true>(logn, *args, s)
                    : launch_logn<false>(logn, *args, s);
}

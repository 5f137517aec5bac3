// PyTorch bindings of the port's CUDA kernels: argument checks, output
// allocation and the launch on the current stream.  The kernels live in the
// .cu files beside this one behind a plain C interface that includes no
// PyTorch header, so nvcc compiles them in seconds; only this file includes
// PyTorch.  Argument errors raise ValueError, launch errors RuntimeError.
//
// Messages are built from std::string and std::to_string alone and thrown
// as pybind11 exceptions: no check formats through c10::str, whose
// std::ostringstream crashed this extension on the H100 machine when a
// failing check streamed an integer into its message.

#include <c10/cuda/CUDAGuard.h>
#include <c10/cuda/CUDAStream.h>
#include <cuda_runtime.h>
#include <torch/extension.h>

#include <cstdint>
#include <stdexcept>
#include <string>
#include <tuple>
#include <vector>

#include "fused.h"
#include "keymul.h"

extern "C" {
int ntt_fwd_launch(const void* x, void* out, const void* psi,
                   const void* psi_shoup, int64_t batch, int n, uint32_t q,
                   void* stream);
int ntt_inv_launch(const void* x, void* out, const void* ipsi,
                   const void* ipsi_shoup, int64_t batch, int n, uint32_t q,
                   uint32_t n_inv, uint32_t n_inv_s, uint32_t tail_w,
                   uint32_t tail_ws, void* stream);
int score_topk_launch(const void* queries, const void* corpus, void* vals,
                      void* idx, int batch, int n_rows, int dim, int kk,
                      int tile, void* stream);
size_t score_topk_smem(int g, int dim, int kk, int tile);
}

namespace {

using torch::Tensor;

[[noreturn]] void value_error(const std::string& msg) {
  throw pybind11::value_error(msg);
}

std::string str(int64_t v) { return std::to_string(v); }

std::string shape(const Tensor& t) {
  std::string s = "(";
  for (int64_t i = 0; i < t.dim(); ++i) {
    if (i > 0) s += ", ";
    s += std::to_string(t.size(i));
  }
  return s + (t.dim() == 1 ? ",)" : ")");
}

// device, dtype and rank; contiguity unless the kernel reads strides
void check_tensor(const Tensor& t, const std::string& name,
                  torch::ScalarType dtype, int64_t dim,
                  bool contiguous = true) {
  if (!t.is_cuda()) {
    value_error(name + " must be a CUDA tensor, got a " +
                c10::DeviceTypeName(t.device().type(), true) + " tensor");
  }
  if (t.scalar_type() != dtype) {
    value_error(name + " must be " + c10::toString(dtype) + ", got " +
                c10::toString(t.scalar_type()));
  }
  if (t.dim() != dim) {
    value_error(name + " must have " + str(dim) + " dimensions, got shape " +
                shape(t));
  }
  if (contiguous && !t.is_contiguous()) {
    value_error(name + " must be contiguous");
  }
}

// the kernels' Barrett step needs q < 2^20 (products < 2^40)
void check_modulus(int64_t q) {
  if (q <= 2 || q >= (int64_t{1} << 20)) {
    value_error("q must lie in (2, 2^20), got " + str(q));
  }
}

void check_ring(int64_t n, int64_t q) {
  if (n < 2 || n > 16384 || (n & (n - 1)) != 0) {
    value_error("N must be a power of two in [2, 16384], got " + str(n));
  }
  check_modulus(q);
}

void check_table(const Tensor& t, const std::string& name, int64_t n) {
  check_tensor(t, name, torch::kInt32, 1);
  if (t.size(0) != n) {
    value_error(name + " has " + str(t.size(0)) + " entries, N is " + str(n));
  }
}

void check_launch(int err, const char* fn) {
  if (err != cudaSuccess) {
    throw std::runtime_error(
        std::string(fn) + " failed: " +
        cudaGetErrorString(static_cast<cudaError_t>(err)));
  }
}

void* stream() { return c10::cuda::getCurrentCUDAStream().stream(); }

// table/shoup: the twiddles and their Shoup quotients; n_inv, tail_w and
// their quotients fold N^-1 into the inverse's last stage (unused forward)
Tensor ntt(const Tensor& x, const Tensor& table, const Tensor& shoup,
           bool inverse, int64_t q, int64_t n_inv, int64_t n_inv_s,
           int64_t tail_w, int64_t tail_ws) {
  check_tensor(x, "x", torch::kInt32, 2);
  const int64_t n = x.size(1);
  check_ring(n, q);
  check_table(table, "table", n);
  check_table(shoup, "shoup", n);
  const c10::cuda::CUDAGuard guard(x.device());
  Tensor out = torch::empty_like(x);
  const auto b = x.size(0);
  const auto nn = static_cast<int>(n);
  const auto qq = static_cast<uint32_t>(q);
  const int err =
      inverse ? ntt_inv_launch(x.data_ptr(), out.data_ptr(), table.data_ptr(),
                               shoup.data_ptr(), b, nn, qq,
                               static_cast<uint32_t>(n_inv),
                               static_cast<uint32_t>(n_inv_s),
                               static_cast<uint32_t>(tail_w),
                               static_cast<uint32_t>(tail_ws), stream())
              : ntt_fwd_launch(x.data_ptr(), out.data_ptr(), table.data_ptr(),
                               shoup.data_ptr(), b, nn, qq, stream());
  check_launch(err, inverse ? "ntt_inv_launch" : "ntt_fwd_launch");
  return out;
}

// b: a's shape with any leading strides (0 where it is broadcast) and unit
// stride in the last dim; its leading dims are collapsed for the kernel
// (keymul.h), innermost first.
BcastArgs bcast_args(const Tensor& b) {
  BcastArgs bc{};
  int dims = 0;
  for (int64_t d = b.dim() - 2; d >= 0; --d) {
    if (b.size(d) == 1) continue;
    if (dims > 0 && b.stride(d) == bc.stride[dims - 1] * bc.size[dims - 1]) {
      bc.size[dims - 1] *= b.size(d);        // merges with its inner neighbour
      continue;
    }
    if (dims == kMaxBcastDims) {
      value_error("b's strides leave more than " + str(kMaxBcastDims) +
                  " leading dims after merging; shape " + shape(b));
    }
    bc.size[dims] = b.size(d);
    bc.stride[dims] = b.stride(d);
    ++dims;
  }
  bc.dims = dims;
  return bc;
}

Tensor pointwise_mul(const Tensor& a, const Tensor& b, int64_t q, int64_t m) {
  check_tensor(a, "a", torch::kInt32, a.dim());
  check_tensor(b, "b", torch::kInt32, a.dim(), false);
  if (a.dim() < 1) value_error("a must have at least one dimension");
  if (a.sizes() != b.sizes()) {
    value_error("shapes differ: " + shape(a) + " vs " + shape(b));
  }
  check_modulus(q);
  const int64_t inner = a.size(-1);
  const int64_t rows = inner > 0 ? a.numel() / inner : 0;
  const int64_t vw = inner % 4 == 0 ? 4 : inner % 2 == 0 ? 2 : 1;
  if (a.numel() / vw >= (int64_t{1} << 31)) {
    value_error("a has " + str(a.numel()) + " elements; the kernel takes " +
                "fewer than 2^31 vectors of " + str(vw));
  }
  if (inner > 1 && b.stride(-1) != 1) {
    value_error("b must have unit stride in its last dim, got " +
                str(b.stride(-1)));
  }
  for (int64_t d = 0; d + 1 < b.dim(); ++d) {
    if (b.stride(d) % vw != 0) {
      value_error("b's strides must be multiples of " + str(vw) +
                  ", got " + str(b.stride(d)) + " in dim " + str(d));
    }
  }
  for (const Tensor* t : {&a, &b}) {
    if (reinterpret_cast<uintptr_t>(t->data_ptr()) % (4 * vw) != 0) {
      value_error("a and b must be " + str(4 * vw) + "-byte aligned");
    }
  }
  const BcastArgs bc = bcast_args(b);
  const c10::cuda::CUDAGuard guard(a.device());
  Tensor out = torch::empty_like(a);
  check_launch(pointwise_mul_launch(a.data_ptr(), b.data_ptr(),
                                    out.data_ptr(), rows, inner, &bc,
                                    static_cast<uint32_t>(q),
                                    static_cast<uint64_t>(m), stream()),
               "pointwise_mul_launch");
  return out;
}

// a (R, P, N): any row and prime strides, unit stride in N; s (K, P, N)
// contiguous, K dividing R (row r takes key r / (R / K)); the (P, N)
// tables of every prime; consts: per prime (q, floor(2^64 / q), N^-1, its
// Shoup quotient, the inverse's folded tail twiddle, its quotient).
Tensor key_mul(const Tensor& a, const Tensor& s, const Tensor& psi,
               const Tensor& psi_shoup, const Tensor& ipsi,
               const Tensor& ipsi_shoup, const std::vector<int64_t>& consts) {
  check_tensor(a, "a", torch::kInt32, 3, false);
  check_tensor(s, "s", torch::kInt32, 3);
  const int64_t rows = a.size(0), primes = a.size(1), n = a.size(2);
  if (primes < 1 || primes > kMaxPrimes) {
    value_error("a has " + str(primes) + " primes; the kernel takes 1 to " +
                str(kMaxPrimes));
  }
  const std::string want = "(" + str(primes) + ", " + str(n) + ")";
  for (const Tensor* t : {&psi, &psi_shoup, &ipsi, &ipsi_shoup}) {
    check_tensor(*t, "tables", torch::kInt32, 2);
    if (t->size(0) != primes || t->size(1) != n) {
      value_error("tables must be (P, N) = " + want + " for a of shape " +
                  shape(a) + ", got " + shape(*t));
    }
  }
  if (static_cast<int64_t>(consts.size()) != 6 * primes) {
    value_error("consts hold " + str(static_cast<int64_t>(consts.size())) +
                " values, want 6 for each of " + str(primes) + " primes");
  }
  for (int64_t p = 0; p < primes; ++p) check_ring(n, consts[6 * p]);
  const int64_t keys = s.size(0);
  if (s.size(1) != primes || s.size(2) != n ||
      (keys < 1 ? rows != 0 : rows % keys != 0)) {
    value_error("keys of shape " + shape(s) + " do not broadcast over a of " +
                "shape " + shape(a) + ": want (K, " + str(primes) + ", " +
                str(n) + ") with K dividing " + str(rows));
  }
  const int64_t vw = n < 4 ? n : 4;
  if (a.stride(2) != 1 || a.stride(0) % vw || a.stride(1) % vw ||
      reinterpret_cast<uintptr_t>(a.data_ptr()) % (4 * vw) != 0 ||
      reinterpret_cast<uintptr_t>(s.data_ptr()) % (4 * vw) != 0) {
    value_error("a must have unit stride in N and strides divisible by " +
                str(vw) + ", a and s " + str(4 * vw) + "-byte aligned; " +
                "a's strides (" + str(a.stride(0)) + ", " + str(a.stride(1)) +
                ", " + str(a.stride(2)) + ")");
  }
  const c10::cuda::CUDAGuard guard(a.device());
  Tensor out = torch::empty({rows, primes, n}, a.options());
  KeyMulArgs k{};
  k.a = a.data_ptr();
  k.stride_row = a.stride(0);
  k.stride_prime = a.stride(1);
  k.s = s.data_ptr();
  k.rows_per_key = keys > 0 ? rows / keys : 0;
  k.psi = psi.data_ptr();
  k.psi_shoup = psi_shoup.data_ptr();
  k.ipsi = ipsi.data_ptr();
  k.ipsi_shoup = ipsi_shoup.data_ptr();
  k.out = out.data_ptr();
  k.rows = rows;
  k.primes = static_cast<int>(primes);
  k.n = static_cast<int>(n);
  for (int64_t p = 0; p < primes; ++p) {
    const int64_t* c = consts.data() + 6 * p;
    k.prime[p] = KeyMulPrime{static_cast<uint32_t>(c[0]),
                             static_cast<uint64_t>(c[1]),
                             static_cast<uint32_t>(c[2]),
                             static_cast<uint32_t>(c[3]),
                             static_cast<uint32_t>(c[4]),
                             static_cast<uint32_t>(c[5])};
  }
  check_launch(key_mul_launch(&k, stream()), "key_mul_launch");
  return out;
}

// The fused re-rank's common arguments: tw/tw_shoup (cpt, N), f0/f1
// (B, chunks, N), every pointer aligned for the kernel's vector loads.
FusedArgs fused_args(const Tensor& tw, const Tensor& tw_shoup,
                     const Tensor& f0, const Tensor& f1, int64_t bsz,
                     int64_t chunks, int64_t n, int64_t q, int64_t m) {
  check_tensor(tw, "tw", torch::kInt32, 2);
  check_tensor(tw_shoup, "tw_shoup", torch::kInt32, 2);
  check_tensor(f0, "f0", torch::kInt32, 3);
  check_tensor(f1, "f1", torch::kInt32, 3);
  check_ring(n, q);
  const int64_t cpt = tw.size(0);
  if (cpt < 1 || tw.size(1) != n || tw_shoup.sizes() != tw.sizes() ||
      f0.size(0) != bsz || f0.size(1) != chunks || f0.size(2) != n ||
      f1.sizes() != f0.sizes()) {
    value_error("inconsistent shapes for B " + str(bsz) + ", chunks " +
                str(chunks) + ", N " + str(n) + ": tw " + shape(tw) +
                ", tw_shoup " + shape(tw_shoup) + ", f0 " + shape(f0) +
                ", f1 " + shape(f1));
  }
  if (cpt * chunks * (q - 1) >= (int64_t{1} << 31)) {
    value_error("int32 accumulator would wrap: " + str(cpt * chunks) +
                " rows at q " + str(q));
  }
  if (bsz >= 65536 || chunks < 1) {
    value_error("need B < 65536 and chunks >= 1, got B " + str(bsz) +
                ", chunks " + str(chunks));
  }
  const int64_t align = 4 * (n < 4 ? n : 4);  // bytes of a vector load
  for (const Tensor* t : {&tw, &tw_shoup, &f0, &f1}) {
    if (reinterpret_cast<uintptr_t>(t->data_ptr()) % align != 0) {
      value_error("tw, tw_shoup, f0 and f1 must be " + str(align) +
                  "-byte aligned");
    }
  }
  FusedArgs a{};
  a.tw = tw.data_ptr();
  a.tw_shoup = tw_shoup.data_ptr();
  a.f0 = f0.data_ptr();
  a.f1 = f1.data_ptr();
  a.batch = static_cast<int>(bsz);
  a.cpt = static_cast<int>(cpt);
  a.chunks = static_cast<int>(chunks);
  a.n = static_cast<int>(n);
  a.q = static_cast<uint32_t>(q);
  a.barrett = static_cast<uint64_t>(m);
  return a;
}

// g (B, nc, chunks, P, N) as the gather produced it, read at prime `prime`
// through its strides; candidates at or past num_cands contribute nothing.
// `name`: the caller's name for g, in messages.
FusedArgs fused_gathered(const Tensor& g, int64_t prime, int64_t num_cands,
                         const Tensor& tw, const Tensor& tw_shoup,
                         const Tensor& f0, const Tensor& f1, int64_t q,
                         int64_t m, const std::string& name = "g") {
  check_tensor(g, name, torch::kInt32, 5, false);
  const int64_t n = g.size(4);
  FusedArgs a = fused_args(tw, tw_shoup, f0, f1, g.size(0), g.size(2), n, q,
                           m);
  if (prime < 0 || prime >= g.size(3)) {
    value_error("prime " + str(prime) + " out of range for g of shape " +
                shape(g));
  }
  if (num_cands < 0 || num_cands > g.size(1) || num_cands >= INT32_MAX) {
    value_error("num_cands " + str(num_cands) + " out of range for g of " +
                "shape " + shape(g));
  }
  const int64_t vw = n < 4 ? n : 4;
  if (g.stride(4) != 1 || g.stride(0) % vw || g.stride(1) % vw ||
      g.stride(2) % vw || g.stride(3) % vw ||
      reinterpret_cast<uintptr_t>(g.data_ptr()) % (4 * vw) != 0) {
    value_error(name + " must have unit stride in N and strides " +
                "divisible by " + str(vw) + ", " + str(4 * vw) +
                "-byte aligned; strides (" + str(g.stride(0)) + ", " +
                str(g.stride(1)) + ", " + str(g.stride(2)) + ", " +
                str(g.stride(3)) + ", " + str(g.stride(4)) + ")");
  }
  a.rows = static_cast<const int32_t*>(g.data_ptr()) + prime * g.stride(3);
  a.stride_b = g.stride(0);
  a.stride_cand = g.stride(1);
  a.stride_chunk = g.stride(2);
  a.num_ct = static_cast<int>((num_cands + a.cpt - 1) / a.cpt);
  a.num_cands = static_cast<int>(num_cands);
  return a;
}

// polys (B, num_ct, cpt * chunks, N), slot-major and contiguous: the
// gathered layout with one prime, (B, num_ct * cpt, chunks, 1, N)
FusedArgs fused_polys(const Tensor& polys, const Tensor& tw,
                      const Tensor& tw_shoup, const Tensor& f0,
                      const Tensor& f1, int64_t q, int64_t m) {
  check_tensor(polys, "polys", torch::kInt32, 4);
  check_tensor(tw, "tw", torch::kInt32, 2);
  check_tensor(f0, "f0", torch::kInt32, 3);
  const int64_t cpt = tw.size(0), chunks = f0.size(1);
  if (cpt < 1 || chunks < 1 || polys.size(2) != cpt * chunks) {
    value_error("polys " + shape(polys) + " must be (B, num_ct, cpt * " +
                "chunks, N) with cpt " + str(cpt) + " and chunks " +
                str(chunks));
  }
  const int64_t cands = polys.size(1) * cpt;
  return fused_gathered(
      polys.view({polys.size(0), cands, chunks, 1, polys.size(3)}), 0, cands,
      tw, tw_shoup, f0, f1, q, m, "polys");
}

std::tuple<Tensor, Tensor> launch_fused(FusedArgs& a, const Tensor& like,
                                        const char* fn) {
  const c10::cuda::CUDAGuard guard(like.device());
  Tensor out0 = torch::empty({a.batch, a.num_ct, a.n}, like.options());
  Tensor out1 = torch::empty_like(out0);
  a.out0 = out0.data_ptr();
  a.out1 = out1.data_ptr();
  check_launch(fused_rerank_launch(&a, stream()), fn);
  return {out0, out1};
}

void intt_args(FusedArgs& a, const Tensor& ipsi, const Tensor& ipsi_shoup,
               int64_t n_inv, int64_t n_inv_s, int64_t tail_w,
               int64_t tail_ws) {
  check_table(ipsi, "ipsi", a.n);
  check_table(ipsi_shoup, "ipsi_shoup", a.n);
  a.ipsi = ipsi.data_ptr();
  a.ipsi_shoup = ipsi_shoup.data_ptr();
  a.n_inv = static_cast<uint32_t>(n_inv);
  a.n_inv_shoup = static_cast<uint32_t>(n_inv_s);
  a.tail_w = static_cast<uint32_t>(tail_w);
  a.tail_ws = static_cast<uint32_t>(tail_ws);
  a.intt = 1;
}

std::tuple<Tensor, Tensor> fused_rerank_intt(
    const Tensor& polys, const Tensor& tw, const Tensor& tw_shoup,
    const Tensor& f0, const Tensor& f1, const Tensor& ipsi,
    const Tensor& ipsi_shoup, int64_t q, int64_t m, int64_t n_inv,
    int64_t n_inv_s, int64_t tail_w, int64_t tail_ws) {
  FusedArgs a = fused_polys(polys, tw, tw_shoup, f0, f1, q, m);
  intt_args(a, ipsi, ipsi_shoup, n_inv, n_inv_s, tail_w, tail_ws);
  return launch_fused(a, polys, "fused_rerank_launch");
}

std::tuple<Tensor, Tensor> fused_rerank_intt_gathered(
    const Tensor& g, int64_t prime, int64_t num_cands, const Tensor& tw,
    const Tensor& tw_shoup, const Tensor& f0, const Tensor& f1,
    const Tensor& ipsi, const Tensor& ipsi_shoup, int64_t q, int64_t m,
    int64_t n_inv, int64_t n_inv_s, int64_t tail_w, int64_t tail_ws) {
  FusedArgs a = fused_gathered(g, prime, num_cands, tw, tw_shoup, f0, f1, q,
                               m);
  intt_args(a, ipsi, ipsi_shoup, n_inv, n_inv_s, tail_w, tail_ws);
  return launch_fused(a, g, "fused_rerank_launch");
}

std::tuple<Tensor, Tensor> fused_rerank(const Tensor& polys, const Tensor& tw,
                                        const Tensor& tw_shoup,
                                        const Tensor& f0, const Tensor& f1,
                                        int64_t q, int64_t m) {
  FusedArgs a = fused_polys(polys, tw, tw_shoup, f0, f1, q, m);
  return launch_fused(a, polys, "fused_rerank_launch");
}

std::tuple<Tensor, Tensor> score_topk(const Tensor& queries,
                                      const Tensor& corpus, int64_t kk,
                                      int64_t tile) {
  check_tensor(queries, "queries", torch::kFloat32, 2);
  check_tensor(corpus, "corpus", torch::kFloat32, 2);
  const int64_t b = queries.size(0), dim = queries.size(1);
  const int64_t n_rows = corpus.size(0);
  if (corpus.size(1) != dim) {
    value_error("dims differ: " + shape(queries) + " vs " + shape(corpus));
  }
  if (kk < 1 || kk > tile || n_rows >= INT32_MAX) {
    value_error("need 1 <= kk <= tile and N < 2^31, got kk=" + str(kk) +
                ", tile=" + str(tile) + ", N=" + str(n_rows));
  }
  if (b >= INT32_MAX || dim >= INT32_MAX || tile >= INT32_MAX ||
      score_topk_smem(1, static_cast<int>(dim), static_cast<int>(kk),
                      static_cast<int>(tile)) > 227 * 1024) {
    value_error("dim " + str(dim) + ", tile " + str(tile) + " and kk " +
                str(kk) + " exceed a block's shared memory");
  }
  const c10::cuda::CUDAGuard guard(queries.device());
  const int64_t num_tiles = (n_rows + tile - 1) / tile;
  Tensor vals = torch::empty({num_tiles, b, kk}, queries.options());
  Tensor idx = torch::empty({num_tiles, b, kk},
                            queries.options().dtype(torch::kInt32));
  check_launch(score_topk_launch(queries.data_ptr(), corpus.data_ptr(),
                                 vals.data_ptr(), idx.data_ptr(),
                                 static_cast<int>(b),
                                 static_cast<int>(n_rows),
                                 static_cast<int>(dim), static_cast<int>(kk),
                                 static_cast<int>(tile), stream()),
               "score_topk_launch");
  return {vals, idx};
}

}  // namespace

PYBIND11_MODULE(TORCH_EXTENSION_NAME, mod) {
  mod.def("ntt", &ntt, "batched negacyclic NTT (csrc/ntt.cu)");
  mod.def("pointwise_mul", &pointwise_mul,
          "elementwise modular product, b read through its strides "
          "(csrc/ntt.cu)");
  mod.def("key_mul", &key_mul,
          "iNTT(NTT(a) * s) for every RNS prime in one launch (csrc/ntt.cu)");
  mod.def("fused_rerank_intt", &fused_rerank_intt,
          "fused rotate/Hadamard/sum/inverse NTT (csrc/fused.cu)");
  mod.def("fused_rerank_intt_gathered", &fused_rerank_intt_gathered,
          "fused_rerank_intt reading the gathered cache rows in place "
          "(csrc/fused.cu)");
  mod.def("fused_rerank", &fused_rerank,
          "fused rotate/Hadamard/sum, NTT domain (csrc/fused.cu)");
  mod.def("score_topk", &score_topk,
          "fused scoring + per-tile top-kk (csrc/scoretopk.cu)");
}

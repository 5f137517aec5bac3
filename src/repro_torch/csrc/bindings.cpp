// PyTorch bindings of the port's CUDA kernels: argument checks, output
// allocation and the launch on the current stream.  The kernels live in the
// .cu files beside this one behind a plain C interface that includes no
// PyTorch header, so nvcc compiles them in seconds; only this file includes
// PyTorch.  Argument errors raise ValueError, launch errors RuntimeError.

#include <c10/cuda/CUDAGuard.h>
#include <c10/cuda/CUDAStream.h>
#include <cuda_runtime.h>
#include <torch/extension.h>

#include <cstdint>
#include <tuple>

extern "C" {
int ntt_fwd_launch(const void* x, void* out, const void* psi,
                   const void* psi_shoup, int64_t batch, int n, uint32_t q,
                   void* stream);
int ntt_inv_launch(const void* x, void* out, const void* ipsi,
                   const void* ipsi_shoup, int64_t batch, int n, uint32_t q,
                   uint32_t n_inv, uint32_t n_inv_s, uint32_t tail_w,
                   uint32_t tail_ws, void* stream);
int pointwise_mul_launch(const void* a, const void* b, void* out,
                         int64_t count, uint32_t q, uint64_t m, void* stream);
int fused_rerank_intt_launch(const void* polys, const void* tw,
                             const void* f0, const void* f1, const void* ipsi,
                             void* out0, void* out1, int batch, int num_ct,
                             int cpt, int chunks, int n, uint32_t q,
                             uint64_t m, uint32_t n_inv, void* stream);
int fused_rerank_launch(const void* polys, const void* tw, const void* f0,
                        const void* f1, void* out0, void* out1, int batch,
                        int num_ct, int cpt, int chunks, int n, uint32_t q,
                        uint64_t m, void* stream);
int score_topk_launch(const void* queries, const void* corpus, void* vals,
                      void* idx, int batch, int n_rows, int dim, int kk,
                      int tile, void* stream);
size_t score_topk_smem(int g, int dim, int kk, int tile);
}

namespace {

using torch::Tensor;

void check_tensor(const Tensor& t, const char* name, torch::ScalarType dtype,
                  int64_t dim) {
  TORCH_CHECK_VALUE(t.is_cuda(), name, " must be a CUDA tensor, got ",
                    t.device());
  TORCH_CHECK_VALUE(t.scalar_type() == dtype, name, " must be ", dtype,
                    ", got ", t.scalar_type());
  TORCH_CHECK_VALUE(t.dim() == dim, name, " must have ", dim,
                    " dimensions, got ", t.sizes());
  TORCH_CHECK_VALUE(t.is_contiguous(), name, " must be contiguous");
}

// the kernels' Barrett step needs q < 2^20 (products < 2^40)
void check_modulus(int64_t q) {
  TORCH_CHECK_VALUE(q > 2 && q < (int64_t{1} << 20),
                    "q must lie in (2, 2^20), got ", q);
}

void check_ring(int64_t n, int64_t q) {
  TORCH_CHECK_VALUE(n >= 2 && n <= 16384 && (n & (n - 1)) == 0,
                    "N must be a power of two in [2, 16384], got ", n);
  check_modulus(q);
}

void check_launch(int err, const char* fn) {
  TORCH_CHECK(err == cudaSuccess, fn, " failed: ",
              cudaGetErrorString(static_cast<cudaError_t>(err)));
}

void* stream() { return c10::cuda::getCurrentCUDAStream().stream(); }

// table/shoup: the twiddles and their Shoup quotients; n_inv, tail_w and
// their quotients fold N^-1 into the inverse's last stage (unused forward)
Tensor ntt(const Tensor& x, const Tensor& table, const Tensor& shoup,
           bool inverse, int64_t q, int64_t n_inv, int64_t n_inv_s,
           int64_t tail_w, int64_t tail_ws) {
  check_tensor(x, "x", torch::kInt32, 2);
  check_tensor(table, "table", torch::kInt32, 1);
  check_tensor(shoup, "shoup", torch::kInt32, 1);
  const int64_t n = x.size(1);
  check_ring(n, q);
  TORCH_CHECK_VALUE(table.size(0) == n && shoup.size(0) == n, "tables have ",
                    table.size(0), " and ", shoup.size(0), " entries, N is ",
                    n);
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

Tensor pointwise_mul(const Tensor& a, const Tensor& b, int64_t q, int64_t m) {
  check_tensor(a, "a", torch::kInt32, a.dim());
  check_tensor(b, "b", torch::kInt32, a.dim());
  TORCH_CHECK_VALUE(a.sizes() == b.sizes(), "shapes differ: ", a.sizes(),
                    " vs ", b.sizes());
  check_modulus(q);
  const c10::cuda::CUDAGuard guard(a.device());
  Tensor out = torch::empty_like(a);
  check_launch(pointwise_mul_launch(a.data_ptr(), b.data_ptr(),
                                    out.data_ptr(), a.numel(),
                                    static_cast<uint32_t>(q),
                                    static_cast<uint64_t>(m), stream()),
               "pointwise_mul_launch");
  return out;
}

// shape checks shared by both fused re-rank kernels: polys (B, num_ct,
// cpt*chunks, N), tw (cpt, N), f0/f1 (B, chunks, N)
void check_fused(const Tensor& polys, const Tensor& tw, const Tensor& f0,
                 const Tensor& f1, int64_t q) {
  check_tensor(polys, "polys", torch::kInt32, 4);
  check_tensor(tw, "tw", torch::kInt32, 2);
  check_tensor(f0, "f0", torch::kInt32, 3);
  check_tensor(f1, "f1", torch::kInt32, 3);
  const int64_t bsz = polys.size(0), num_ct = polys.size(1);
  const int64_t rows = polys.size(2), n = polys.size(3);
  const int64_t cpt = tw.size(0), chunks = f0.size(1);
  check_ring(n, q);
  TORCH_CHECK_VALUE(rows == cpt * chunks, "rows ", rows, " != cpt ", cpt,
                    " * chunks ", chunks);
  TORCH_CHECK_VALUE(tw.size(1) == n && f0.size(0) == bsz && f0.size(2) == n &&
                        f1.sizes() == f0.sizes(),
                    "inconsistent shapes: polys ", polys.sizes(), ", tw ",
                    tw.sizes(), ", f0 ", f0.sizes(), ", f1 ", f1.sizes());
  TORCH_CHECK_VALUE(rows * (q - 1) < (int64_t{1} << 31),
                    "int32 accumulator would wrap: rows ", rows, ", q ", q);
  TORCH_CHECK_VALUE(bsz < 65536 && num_ct < INT32_MAX, "grid too large");
}

std::tuple<Tensor, Tensor> fused_rerank_intt(const Tensor& polys,
                                             const Tensor& tw,
                                             const Tensor& f0,
                                             const Tensor& f1,
                                             const Tensor& ipsi, int64_t q,
                                             int64_t m, int64_t n_inv) {
  check_fused(polys, tw, f0, f1, q);
  check_tensor(ipsi, "ipsi", torch::kInt32, 1);
  const int64_t bsz = polys.size(0), num_ct = polys.size(1);
  const int64_t n = polys.size(3);
  TORCH_CHECK_VALUE(ipsi.size(0) == n, "ipsi has ", ipsi.size(0),
                    " entries, N is ", n);
  const c10::cuda::CUDAGuard guard(polys.device());
  Tensor out0 = torch::empty({bsz, num_ct, n}, polys.options());
  Tensor out1 = torch::empty_like(out0);
  check_launch(fused_rerank_intt_launch(
                   polys.data_ptr(), tw.data_ptr(), f0.data_ptr(),
                   f1.data_ptr(), ipsi.data_ptr(), out0.data_ptr(),
                   out1.data_ptr(), static_cast<int>(bsz),
                   static_cast<int>(num_ct), static_cast<int>(tw.size(0)),
                   static_cast<int>(f0.size(1)), static_cast<int>(n),
                   static_cast<uint32_t>(q), static_cast<uint64_t>(m),
                   static_cast<uint32_t>(n_inv), stream()),
               "fused_rerank_intt_launch");
  return {out0, out1};
}

std::tuple<Tensor, Tensor> fused_rerank(const Tensor& polys, const Tensor& tw,
                                        const Tensor& f0, const Tensor& f1,
                                        int64_t q, int64_t m) {
  check_fused(polys, tw, f0, f1, q);
  const int64_t bsz = polys.size(0), num_ct = polys.size(1);
  const int64_t n = polys.size(3);
  const c10::cuda::CUDAGuard guard(polys.device());
  Tensor out0 = torch::empty({bsz, num_ct, n}, polys.options());
  Tensor out1 = torch::empty_like(out0);
  check_launch(fused_rerank_launch(
                   polys.data_ptr(), tw.data_ptr(), f0.data_ptr(),
                   f1.data_ptr(), out0.data_ptr(), out1.data_ptr(),
                   static_cast<int>(bsz), static_cast<int>(num_ct),
                   static_cast<int>(tw.size(0)), static_cast<int>(f0.size(1)),
                   static_cast<int>(n), static_cast<uint32_t>(q),
                   static_cast<uint64_t>(m), stream()),
               "fused_rerank_launch");
  return {out0, out1};
}

std::tuple<Tensor, Tensor> score_topk(const Tensor& queries,
                                      const Tensor& corpus, int64_t kk,
                                      int64_t tile) {
  check_tensor(queries, "queries", torch::kFloat32, 2);
  check_tensor(corpus, "corpus", torch::kFloat32, 2);
  const int64_t b = queries.size(0), dim = queries.size(1);
  const int64_t n_rows = corpus.size(0);
  TORCH_CHECK_VALUE(corpus.size(1) == dim, "dims differ: ", queries.sizes(),
                    " vs ", corpus.sizes());
  TORCH_CHECK_VALUE(1 <= kk && kk <= tile && n_rows < INT32_MAX,
                    "need 1 <= kk <= tile and N < 2^31, got kk=", kk,
                    ", tile=", tile, ", N=", n_rows);
  TORCH_CHECK_VALUE(b < INT32_MAX && dim < INT32_MAX && tile < INT32_MAX &&
                        score_topk_smem(1, static_cast<int>(dim),
                                        static_cast<int>(kk),
                                        static_cast<int>(tile)) <= 227 * 1024,
                    "dim ", dim, ", tile ", tile, " and kk ", kk,
                    " exceed a block's shared memory");
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
          "elementwise modular product (csrc/ntt.cu)");
  mod.def("fused_rerank_intt", &fused_rerank_intt,
          "fused rotate/Hadamard/sum/inverse NTT (csrc/fused.cu)");
  mod.def("fused_rerank", &fused_rerank,
          "fused rotate/Hadamard/sum, NTT domain (csrc/fused.cu)");
  mod.def("score_topk", &score_topk,
          "fused scoring + per-tile top-kk (csrc/scoretopk.cu)");
}

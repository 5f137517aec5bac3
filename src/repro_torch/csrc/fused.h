// Argument block of the fused re-rank launch: plain C, shared by the
// binding (bindings.cpp) and the kernels (fused.cu).
#pragma once

#include <cstdint>

struct FusedArgs {
  // int32 cache rows, read in place: the row of (lane b, candidate cand,
  // chunk c) starts at rows + b * stride_b + cand * stride_cand +
  // c * stride_chunk and holds N contiguous coefficients
  const void* rows;
  int64_t stride_b, stride_cand, stride_chunk;
  const void* tw;          // (cpt, N) slot twiddles
  const void* tw_shoup;    // (cpt, N) their Shoup quotients
  const void* f0;          // (B, chunks, N) query NTTs, component 0
  const void* f1;          // (B, chunks, N) component 1
  const void* ipsi;        // (N,) inverse NTT twiddles (intt only)
  const void* ipsi_shoup;  // (N,) their Shoup quotients (intt only)
  void* out0;              // (B, num_ct, N) component 0
  void* out1;              // (B, num_ct, N) component 1
  int batch, num_ct, num_cands, cpt, chunks, n;
  uint32_t q;
  uint64_t barrett;        // floor(2^64 / q)
  // the inverse NTT's last stage with N^-1 folded in (intt only)
  uint32_t n_inv, n_inv_shoup, tail_w, tail_ws;
  int intt;                // 1: inverse NTT of the pair; 0: NTT domain out
};

extern "C" int fused_rerank_launch(const FusedArgs* args, void* stream);

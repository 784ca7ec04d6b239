// The entries of the wide-k route of kernels B1 and B2 (k > 512,
// ops/nnls_cuda.py `nnls_wide_plan`); nnls_wide.cuh holds the kernels and
// their note. B1 replaces singlet_tpu/ops/pallas_nnls.py
// `nnls_batch_pallas`, B2 `nnls_batch_pallas_batched_at`, at ranks their
// tuned routes (nnls_cd.cu, nnls_cd_batched.cu) do not take.
//
// All pointers are device pointers to contiguous float32 (mask: uint8, or
// null for all columns active; row_start: int32): B / X0 / X (n, k), l1
// (n, k) per-coordinate L1 or null for the scalar L1. warps, blocks, depth
// and lanes are the plan's: with depth > 0 a staged kernel (`warps` = C
// columns a block, 8, 4, 2 or 1, `lanes` = P threads a column, 32, 64,
// 128 or 256, C P <= 256, ceil(k / P) <= 64, `blocks` = ceil(n / C),
// scratch null), else the warp-a-column kernel, its state in shared
// memory (scratch null) or in scratch, 2 k floats for each of the grid's
// blocks * warps warps. counts: null, or two uint64 that the call adds its
// columns' sweeps and its columns to.
// Each returns the cudaError_t of the launch (0 on success).

#include <cuda_runtime.h>
#include <stdint.h>

#include "nnls_wide.cuh"

namespace {

nnls_wide::Args wide_args(const float* B, const float* X0,
                          const uint8_t* mask, const float* l1, float* X,
                          float* scratch, int n, int k, int warps, int depth,
                          int lanes, float L1, float L2, float k_div,
                          float cap, int max_sweeps,
                          unsigned long long* counts) {
  nnls_wide::Args p{};
  p.B = B;
  p.X0 = X0;
  p.mask = mask;
  p.l1 = l1;
  p.X = X;
  p.scratch = scratch;
  p.counts = counts;
  p.n = n;
  p.k = k;
  p.warps = warps;
  p.depth = depth;
  p.lanes = lanes;
  p.max_sweeps = max_sweeps;
  p.L1 = L1;
  p.L2 = L2;
  p.k_div = k_div;
  p.cap = cap;
  return p;
}

bool aligned16(const void* ptr) {
  return reinterpret_cast<uintptr_t>(ptr) % 16 == 0;
}

// the floats a copy of the staged kernel may take from a row's columns: 4
// (16 bytes) where every row starts 16-byte aligned, 2 where 8-byte, else 1
int rows_vec(const void* ptr, int n) {
  const uintptr_t a = reinterpret_cast<uintptr_t>(ptr);
  if (n % 4 == 0 && a % 16 == 0) return 4;
  if (n % 2 == 0 && a % 8 == 0) return 2;
  return 1;
}

}  // namespace

extern "C" {

// B1: aT (k, round4(k)) the transposed shared Gram, aT[i, t] = a[t, i],
// its rows zero past k and 16-byte aligned. With a depth, the quad kernel
// on a ring of its own where it fits (nnls_wide.cuh `quad_fits`), else
// the staged kernel on the plan's depth.
int nnls_wide_b1(const float* aT, const float* l1, const float* B,
                 const float* X0, const uint8_t* mask, float* X,
                 float* scratch, int n, int k, int warps, int blocks,
                 int depth, int lanes, float L1, float L2, float k_div,
                 float cap, int max_sweeps, unsigned long long* counts,
                 void* stream) {
  if (!aligned16(aT)) return cudaErrorInvalidValue;
  return nnls_wide::launch(
      wide_args(B, X0, mask, l1, X, scratch, n, k, warps, depth, lanes, L1,
                L2, k_div, cap, max_sweeps, counts),
      nnls_wide::SharedGram{aT, k, nnls_wide::round4(k)}, blocks,
      static_cast<cudaStream_t>(stream));
}

// B2's tile entry: at (k, k, n) with at[i, j, c] = a_c[j, i], inv_diag
// (k, n) = 1 / a_c[i, i].
int nnls_wide_b2(const float* at, const float* inv_diag, const float* B,
                 const float* X0, const uint8_t* mask, const float* l1,
                 float* X, float* scratch, int n, int k, int warps,
                 int blocks, int depth, int lanes, float L1, float L2,
                 float k_div, float cap, int max_sweeps,
                 unsigned long long* counts, void* stream) {
  return nnls_wide::launch(
      wide_args(B, X0, mask, l1, X, scratch, n, k, warps, depth, lanes, L1,
                L2, k_div, cap, max_sweeps, counts),
      nnls_wide::TileGram{at, inv_diag, n, k, rows_vec(at, n)},
      blocks, static_cast<cudaStream_t>(stream));
}

// B2's packed entry: a_full (k, round4(k)) 16-byte aligned, its rows zero
// past k; packed_t (k (k + 1) / 2, n) and row_start (k,) of the row-major
// upper triangle, pos(r, j >= r) = row_start[r] + j - r; a_c[j, i] =
// a_full[i, j] - packed_t[pos(i, j), c], 1 / a_c[i, i] formed here.
int nnls_wide_b2_packed(const float* a_full, const float* packed_t,
                        const int* row_start, const float* B,
                        const float* X0, const uint8_t* mask,
                        const float* l1, float* X, float* scratch, int n,
                        int k, int warps, int blocks, int depth, int lanes,
                        float L1, float L2, float k_div, float cap,
                        int max_sweeps, unsigned long long* counts,
                        void* stream) {
  if (!aligned16(a_full)) return cudaErrorInvalidValue;
  return nnls_wide::launch(
      wide_args(B, X0, mask, l1, X, scratch, n, k, warps, depth, lanes, L1,
                L2, k_div, cap, max_sweeps, counts),
      nnls_wide::PackedGram{a_full, packed_t, row_start, n, k,
                            nnls_wide::round4(k),
                            rows_vec(packed_t, n)},
      blocks, static_cast<cudaStream_t>(stream));
}

const char* nnls_wide_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"

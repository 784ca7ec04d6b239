// Batched warm-started coordinate-descent NNLS against one shared Gram
// matrix: kernel B1 of the port, for sm_90a.
//
// Replaces singlet_tpu/ops/pallas_nnls.py `nnls_batch_pallas` (kernel body
// `_nnls_kernel`). It computes, for every column c of B (n, k), what the
// plain version `singlet_tpu_torch.ops.nnls.nnls_batch` computes with a 2-D
// Gram and scalar L1:
//
//   repeat sweeps:  for i in 0..k-1:
//     diff  = b_i * inv_diag_i - L1 + L2 * x_i
//     delta = max(diff, -x_i)                 (clamp at zero)
//     x_i  += delta;  b -= a[:, i] * delta    (incremental residual downdate)
//   tol = sum_i |x_i - x_prev_i| / (x_i + 1e-15)
//   stop when tol / k_div <= 1e-8, or sweep >= max_sweeps, or sweep >= cap
//
// b starts at the RAW right-hand side (not B - a X0) and x at X0: with the
// caller's column rescale that is the reference's damped update. Columns
// whose mask byte is 0 return X0 bit for bit.
//
// Design, and what bounds it. The work is a sequential Gauss-Seidel chain
// of k dependent steps per sweep with a data-dependent exit per column; B,
// X0 and X cross device memory once each, so bytes do not bound it. The
// bound is the latency (and, at full occupancy, the issue slots) of the
// k-step chain. The TPU kernel blocked 4096 columns into a (k, block)
// sublane layout and recomputed residual groups of 16 on the matrix unit;
// that layout exists for the TPU and is not carried over. Here one warp
// owns one column: lane l keeps coordinates l, l+32, ... of x and of the
// residual in registers; the owner of coordinate i is lane i % 32, its
// b_i and x_i are broadcast with __shfl_sync, every lane evaluates the
// (identical) step and downdates its own residual entries from column i
// of the Gram. At n = 8192 columns that is 8192 independent warps, enough
// to fill all 132 SMs, and each warp exits as soon as its column
// converges. The Gram is staged once per block into dynamic shared memory
// TRANSPOSED (aT[i*k + c] = a[c*k + i]) so that the lanes read column i of
// `a` at consecutive addresses, without bank conflicts, and without
// assuming the Gram is bitwise symmetric; 1/diag follows it.
//
// Arithmetic is written with the _rn intrinsics so that nvcc contracts
// nothing into FMAs: each step then rounds exactly like the plain PyTorch
// version's separate elementwise kernels, and the only difference left is
// the summation order of the sweep tolerance. Build WITHOUT --use_fast_math:
// the clamp term x_i / 1e-15 and the tol / k <= 1e-8 exit need IEEE
// division and denormals kept.
//
// Ranks above 224. The (k, k) Gram and 1/diag take (k^2 + k) * 4 bytes of
// shared memory, 201,600 at k = 224 and more than a block may use (232,448)
// past k = 240, and a lane keeps ceil(k / 32) coordinates. For k > 224 the
// entry point `nnls_cd_global` runs the same kernel with the transposed Gram
// (made by the caller) and 1/diag read from device memory through L1 and L2
// (1 MiB at k = 512, shared by every column) and up to 16 coordinates a
// lane: k <= 512. The arithmetic is the same, so only speed differs.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 8;            // columns (warps) per block
constexpr float kCdTol = 1e-8f;      // CD_TOL of ops/nnls.py
constexpr unsigned kFull = 0xffffffffu;

// NPL: coordinates per lane, k <= 32 * NPL. kGlobal: `a` is the TRANSPOSED
// Gram, read with 1/diag from device memory, not staged in shared memory.
template <int NPL, bool kGlobal>
__global__ void __launch_bounds__(kWarps * 32)
nnls_cd_shared_kernel(const float* __restrict__ a,
                      const float* __restrict__ inv_diag,
                      const float* __restrict__ B,
                      const float* __restrict__ X0,
                      const uint8_t* __restrict__ mask,
                      float* __restrict__ X,
                      int n, int k, float L1, float L2, float k_div,
                      float cap, int max_sweeps) {
  extern __shared__ float smem[];
  const float* aT = a;          // (k, k): row i holds column i of a
  const float* inv = inv_diag;  // (k,)
  if constexpr (!kGlobal) {
    float* sT = smem;
    float* s_inv = smem + k * k;
    for (int idx = threadIdx.x; idx < k * k; idx += blockDim.x) {
      const int i = idx / k;
      const int c = idx - i * k;
      sT[idx] = a[c * k + i];
    }
    for (int i = threadIdx.x; i < k; i += blockDim.x) s_inv[i] = inv_diag[i];
    __syncthreads();
    aT = sT;
    inv = s_inv;
  }

  const int lane = threadIdx.x & 31;
  const int col = blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (col >= n) return;
  const float* b_row = B + (size_t)col * k;
  const float* x0_row = X0 + (size_t)col * k;
  float* x_row = X + (size_t)col * k;
  if (mask != nullptr && mask[col] == 0) {
    for (int c = lane; c < k; c += 32) x_row[c] = x0_row[c];
    return;
  }

  float x[NPL], b[NPL];
#pragma unroll
  for (int s = 0; s < NPL; ++s) {
    const int c = s * 32 + lane;
    x[s] = c < k ? x0_row[c] : 0.f;
    b[s] = c < k ? b_row[c] : 0.f;
  }

  for (int sweep = 1;; ++sweep) {
    float x_prev[NPL];
#pragma unroll
    for (int s = 0; s < NPL; ++s) x_prev[s] = x[s];

#pragma unroll
    for (int s = 0; s < NPL; ++s) {
      const int jmax = min(32, k - s * 32);
      for (int j = 0; j < jmax; ++j) {
        const int i = s * 32 + j;
        const float b_i = __shfl_sync(kFull, b[s], j);
        const float x_i = __shfl_sync(kFull, x[s], j);
        const float diff = __fadd_rn(__fsub_rn(__fmul_rn(b_i, inv[i]), L1),
                                     __fmul_rn(L2, x_i));
        const float delta = fmaxf(diff, -x_i);
        if (lane == j) x[s] = __fadd_rn(x_i, delta);
        const float* a_i = aT + i * k;
#pragma unroll
        for (int t = 0; t < NPL; ++t) {
          const int c = t * 32 + lane;
          if (c < k) b[t] = __fsub_rn(b[t], __fmul_rn(a_i[c], delta));
        }
      }
    }

    float tol = 0.f;
#pragma unroll
    for (int s = 0; s < NPL; ++s) {
      if (s * 32 + lane < k) {
        tol = __fadd_rn(tol, __fdiv_rn(fabsf(__fsub_rn(x[s], x_prev[s])),
                                       __fadd_rn(x[s], 1e-15f)));
      }
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      tol = __fadd_rn(tol, __shfl_xor_sync(kFull, tol, off));
    }
    if (!(__fdiv_rn(tol, k_div) > kCdTol) || sweep >= max_sweeps ||
        !((float)sweep < cap)) {
      break;
    }
  }

#pragma unroll
  for (int s = 0; s < NPL; ++s) {
    const int c = s * 32 + lane;
    if (c < k) x_row[c] = x[s];
  }
}

template <int NPL, bool kGlobal = false>
cudaError_t launch(const float* a, const float* inv_diag, const float* B,
                   const float* X0, const uint8_t* mask, float* X, int n,
                   int k, float L1, float L2, float k_div, float cap,
                   int max_sweeps, cudaStream_t stream) {
  const size_t smem = kGlobal ? 0 : (size_t)(k * k + k) * sizeof(float);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        nnls_cd_shared_kernel<NPL, kGlobal>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
  }
  const int blocks = (n + kWarps - 1) / kWarps;
  nnls_cd_shared_kernel<NPL, kGlobal><<<blocks, kWarps * 32, smem, stream>>>(
      a, inv_diag, B, X0, mask, X, n, k, L1, L2, k_div, cap, max_sweeps);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// All pointers are device pointers to contiguous float32 (mask: uint8, or
// null for all columns active); a (k, k), inv_diag (k,), B / X0 / X (n, k).
// Returns the cudaError_t of the launch (0 on success).
int nnls_cd_shared(const float* a, const float* inv_diag, const float* B,
                   const float* X0, const uint8_t* mask, float* X, int n,
                   int k, float L1, float L2, float k_div, float cap,
                   int max_sweeps, void* stream) {
  if (n <= 0) return cudaSuccess;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch ((k + 31) / 32) {
    case 1: return launch<1>(a, inv_diag, B, X0, mask, X, n, k, L1, L2, k_div, cap, max_sweeps, s);
    case 2: return launch<2>(a, inv_diag, B, X0, mask, X, n, k, L1, L2, k_div, cap, max_sweeps, s);
    case 3: return launch<3>(a, inv_diag, B, X0, mask, X, n, k, L1, L2, k_div, cap, max_sweeps, s);
    case 4: return launch<4>(a, inv_diag, B, X0, mask, X, n, k, L1, L2, k_div, cap, max_sweeps, s);
    case 5: return launch<5>(a, inv_diag, B, X0, mask, X, n, k, L1, L2, k_div, cap, max_sweeps, s);
    case 6: return launch<6>(a, inv_diag, B, X0, mask, X, n, k, L1, L2, k_div, cap, max_sweeps, s);
    case 7: return launch<7>(a, inv_diag, B, X0, mask, X, n, k, L1, L2, k_div, cap, max_sweeps, s);
    default: return cudaErrorInvalidValue;
  }
}

// As nnls_cd_shared, for 224 < k <= 512, with aT the TRANSPOSED Gram (aT[i,
// c] = a[c, i]) in device memory.
int nnls_cd_global(const float* aT, const float* inv_diag, const float* B,
                   const float* X0, const uint8_t* mask, float* X, int n,
                   int k, float L1, float L2, float k_div, float cap,
                   int max_sweeps, void* stream) {
  if (n <= 0) return cudaSuccess;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int npl = (k + 31) / 32;
  if (k <= 0 || npl > 16) return cudaErrorInvalidValue;
  if (npl <= 8) return launch<8, true>(aT, inv_diag, B, X0, mask, X, n, k, L1, L2, k_div, cap, max_sweeps, s);
  if (npl <= 12) return launch<12, true>(aT, inv_diag, B, X0, mask, X, n, k, L1, L2, k_div, cap, max_sweeps, s);
  return launch<16, true>(aT, inv_diag, B, X0, mask, X, n, k, L1, L2, k_div, cap, max_sweeps, s);
}

const char* nnls_cd_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"

// The wide-k route of kernels B1 and B2 (k > 512), shared by
// nnls_cd.cu and nnls_cd_batched.cu.
//
// B1 and B2 hold a column's coordinates in registers, at most 16 a lane,
// so their tuned routes end at k = 512. Past it a warp owns a column: its
// x and its running residual b (the gradient the CD steps downdate) sit in
// shared memory, as many columns a block as fit (8 at most; 2 k floats a
// column), or, where one column's 8 k bytes exceed a block's shared
// memory, in a scratch buffer in device memory that the caller allocates.
// Lane l owns coordinates l, l + 32, ...: at step i the owner lane i mod
// 32 reads its own b_i and x_i (it wrote them), computes
//
//   diff  = b_i * inv_i - L1_i + L2 * x_i,  delta = max(diff, -x_i)
//                                          (a NaN kept, `cd_clamp`)
//   x_i  += delta
//
// and its sweep term |x_i - x_start| / (x_i + 1e-15), broadcasts delta by
// shuffle, and every lane downdates its own coordinates, b_t -= a_c[t, i]
// delta, with the Gram's column i read from device memory (the GRAM
// accessor: B1's transposed shared Gram, B2's tiles or its a_full and
// packed corrections), 8 entries a lane loaded before any is used. No
// location is touched by two lanes, so the route needs no barrier. Each
// lane sums its terms in step order and the warp sums the lanes' partials
// by the xor butterfly 16, 8, 4, 2, 1 (the order of the parent of B1's
// tuned route). Every step rounds as the plain
// version does (the _rn intrinsics, no contraction into FMAs).
//
// What bounds it: a chain of k dependent steps a sweep, each a shuffle and
// ceil(k / 32) downdates a lane, whose Gram entries come from L2 (B1's
// k^2 floats are shared by every column; B2 reads each column's own Gram,
// 4 bytes a lane, in sectors that neighbouring columns share). It is a
// correct route for ranks the tuned kernels do not take, not a fast one.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

// max(diff, -x_i) of the CD step, as torch.maximum and jnp.maximum take
// it: a NaN in either operand gives NaN (PTX max.NaN, sm_80+). fmaxf
// would return the other operand, so a zero Gram diagonal (1/diag inf,
// b_i * inf NaN) would clamp x_i to 0 where the plain version's column
// turns NaN. Wherever neither operand is NaN it equals fmaxf, bit for bit.
__device__ __forceinline__ float cd_clamp(float diff, float neg_x) {
  float r;
  asm("max.NaN.f32 %0, %1, %2;" : "=f"(r) : "f"(diff), "f"(neg_x));
  return r;
}

namespace nnls_wide {

constexpr unsigned kFull = 0xffffffffu;
constexpr float kCdTol = 1e-8f;        // CD_TOL of ops/nnls.py
constexpr int kMaxWarps = 8;           // columns (warps) a block
constexpr int kBatch = 8;              // Gram entries a lane loads at once
constexpr size_t kSmemMax = 232448;    // a Hopper block's shared memory

struct Args {
  const float* B;         // (n, k)
  const float* X0;        // (n, k)
  const uint8_t* mask;    // (n,) or null
  const float* l1;        // (n, k) per-coordinate L1, or null for L1
  float* X;               // (n, k)
  float* scratch;         // device-memory state: 2 k floats a warp slot of
                          // the grid, or null for shared memory
  int n, k, max_sweeps;
  int warps;              // columns a block
  float L1, L2, k_div, cap;
};

// GRAM: float entry(col, i, t) = a_col[t, i] and float inv(col, i) =
// 1 / a_col[i, i], both as the plain version rounds them
template <class GRAM>
__global__ void __launch_bounds__(kMaxWarps * 32)
wide_kernel(const Args p, const GRAM gram) {
  extern __shared__ __align__(16) float smem[];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int k = p.k;
  const int slot = blockIdx.x * p.warps + warp;
  float* state = p.scratch != nullptr ? p.scratch + (size_t)slot * 2 * k
                                      : smem + (size_t)warp * 2 * k;
  float* x = state;
  float* b = state + k;
  for (long long col = slot; col < p.n;
       col += (long long)gridDim.x * p.warps) {
    const size_t row = (size_t)col * k;
    const bool active = p.mask == nullptr || p.mask[col] != 0;
    if (!active) {
      for (int t = lane; t < k; t += 32) p.X[row + t] = p.X0[row + t];
      continue;
    }
    for (int t = lane; t < k; t += 32) {
      x[t] = p.X0[row + t];
      b[t] = p.B[row + t];
    }
    for (int sweep = 1;; ++sweep) {
      float part = 0.f;   // this lane's terms, in step order
      for (int i = 0; i < k; ++i) {
        const int owner = i & 31;
        float d = 0.f;
        if (lane == owner) {
          const float xi = x[i];
          const float l1 = p.l1 == nullptr ? p.L1 : p.l1[row + i];
          const float diff =
              __fadd_rn(__fsub_rn(__fmul_rn(b[i], gram.inv(col, i)), l1),
                        __fmul_rn(p.L2, xi));
          d = cd_clamp(diff, -xi);
          const float xn = __fadd_rn(xi, d);
          x[i] = xn;
          part = __fadd_rn(part, __fdiv_rn(fabsf(__fsub_rn(xn, xi)),
                                           __fadd_rn(xn, 1e-15f)));
        }
        const float delta = __shfl_sync(kFull, d, owner);
        // the lane's coordinates kBatch at a time, their Gram entries
        // loaded together before any is used, so that their trips to L2
        // overlap
        for (int t0 = lane; t0 < k; t0 += 32 * kBatch) {
          float av[kBatch];
#pragma unroll
          for (int u = 0; u < kBatch; ++u) {
            const int t = t0 + 32 * u;
            av[u] = t < k ? gram.entry(col, i, t) : 0.f;
          }
#pragma unroll
          for (int u = 0; u < kBatch; ++u) {
            const int t = t0 + 32 * u;
            if (t < k) b[t] = __fsub_rn(b[t], __fmul_rn(av[u], delta));
          }
        }
      }
      float tol = part;
#pragma unroll
      for (int off = 16; off >= 1; off >>= 1) {
        tol = __fadd_rn(tol, __shfl_xor_sync(kFull, tol, off));
      }
      if (!(__fdiv_rn(tol, p.k_div) > kCdTol) || sweep >= p.max_sweeps ||
          !((float)sweep < p.cap)) {
        break;
      }
    }
    for (int t = lane; t < k; t += 32) p.X[row + t] = x[t];
  }
}

// the launch of a plan: `blocks` blocks of `warps` columns; with scratch
// null each block holds warps * 2 k floats of dynamic shared memory
template <class GRAM>
cudaError_t launch(Args p, const GRAM& gram, int blocks, cudaStream_t s) {
  if (p.n <= 0) return cudaSuccess;
  if (p.k <= 0 || p.warps < 1 || p.warps > kMaxWarps || blocks < 1) {
    return cudaErrorInvalidValue;
  }
  const size_t smem =
      p.scratch != nullptr ? 0 : (size_t)p.warps * 2 * p.k * sizeof(float);
  if (smem > kSmemMax) return cudaErrorInvalidValue;
  auto kernel = wide_kernel<GRAM>;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
  }
  kernel<<<blocks, p.warps * 32, smem, s>>>(p, gram);
  return cudaGetLastError();
}

}  // namespace nnls_wide

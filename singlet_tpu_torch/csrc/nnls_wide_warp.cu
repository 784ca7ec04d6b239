// The warp-a-column kernel of B1's and B2's wide-k route as it was before
// the staged kernel (csrc/nnls_wide.cuh `staged_kernel`) replaced it up to
// k = 2048: its header's kernel and its entries, with their Gram
// accessors, from nnls_cd.cu and nnls_cd_batched.cu. No route of the
// package calls it: ab_nnls.py and ab_nnls_batched.py (`--wide`, and
// chip_smoke.py phase 10b through them) time the staged kernel against it
// in turns on the same inputs and hold the two to the same bits.
// nnls_wide.cuh keeps the same kernel (`wide_kernel`) past the staged
// kernels' reach (k > 6,452 for B2, 11,612 for B1) and for the scratch
// route; this copy keeps the code as it was compiled before, in one source
// of its own.

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

namespace nnls_wide_warp {

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

}  // namespace nnls_wide_warp

namespace {

using nnls_wide_warp::Args;

// the wide route's Gram: one (k, k) for every column, transposed (row i
// holds column i of a), its diagonal's reciprocal correctly rounded as
// the plain version's division
struct SharedGram {
  const float* aT;
  int k;
  __device__ __forceinline__ float entry(long long, int i, int t) const {
    return __ldg(aT + (size_t)i * k + t);
  }
  __device__ __forceinline__ float inv(long long, int i) const {
    return __frcp_rn(__ldg(aT + (size_t)i * k + i));
  }
};


// the wide route's Grams: the tiles at (k, k, n) with 1/diag (k, n) from
// the wrapper
struct TileGram {
  const float* at;
  const float* inv_diag;
  int n, k;
  __device__ __forceinline__ float entry(long long c, int i, int t) const {
    return __ldg(at + ((size_t)i * k + t) * n + c);
  }
  __device__ __forceinline__ float inv(long long c, int i) const {
    return __ldg(inv_diag + (size_t)i * n + c);
  }
};

// and the packed entry's: a_c[t, i] = a_full[i, t] - packed_t[pos(i, t),
// c], pos(r, j >= r) = row_start[r] + j - r, 1/diag formed as the tuned
// route forms it
struct PackedGram {
  const float* a_full;
  const float* packed_t;
  const int* row_start;
  int n, k;
  __device__ __forceinline__ float entry(long long c, int i, int t) const {
    const int lo = i < t ? i : t;
    const int pos = __ldg(row_start + lo) + (i < t ? t - i : i - t);
    return __fsub_rn(__ldg(a_full + (size_t)i * k + t),
                     __ldg(packed_t + (size_t)pos * n + c));
  }
  __device__ __forceinline__ float inv(long long c, int i) const {
    const int pos = __ldg(row_start + i);
    return __frcp_rn(__fsub_rn(__ldg(a_full + (size_t)i * k + i),
                               __ldg(packed_t + (size_t)pos * n + c)));
  }
};

Args wide_args(const float* B, const float* X0, const uint8_t* mask,
               const float* l1, float* X, float* scratch, int n, int k,
               int warps, float L1, float L2, float k_div, float cap,
               int max_sweeps) {
  Args p{};
  p.B = B;
  p.X0 = X0;
  p.mask = mask;
  p.l1 = l1;
  p.X = X;
  p.scratch = scratch;
  p.n = n;
  p.k = k;
  p.warps = warps;
  p.max_sweeps = max_sweeps;
  p.L1 = L1;
  p.L2 = L2;
  p.k_div = k_div;
  p.cap = cap;
  return p;
}

}  // namespace

extern "C" {

// B1 (k > 512, on the plan of ab_nnls_batched.py `warp_plan`): aT (k, k)
// the transposed shared Gram, aT[i, t] = a[t, i]; l1 (n, k) or null for
// the scalar L1; scratch null (x and the residual in shared memory, `warps`
// columns a block) or 2 k floats for each of the grid's blocks * warps
// warps. Returns the cudaError_t of the launch (0 on success).
int nnls_cd_wide(const float* aT, const float* l1, const float* B,
                 const float* X0, const uint8_t* mask, float* X,
                 float* scratch, int n, int k, int warps, int blocks,
                 float L1, float L2, float k_div, float cap, int max_sweeps,
                 void* stream) {
  Args p{};
  p.B = B;
  p.X0 = X0;
  p.mask = mask;
  p.l1 = l1;
  p.X = X;
  p.scratch = scratch;
  p.n = n;
  p.k = k;
  p.max_sweeps = max_sweeps;
  p.warps = warps;
  p.L1 = L1;
  p.L2 = L2;
  p.k_div = k_div;
  p.cap = cap;
  return nnls_wide_warp::launch(p, SharedGram{aT, k}, blocks,
                                static_cast<cudaStream_t>(stream));
}

// B2's two entries (k > 512, on the plan of `warp_plan`): the tile
// entry's at and inv_diag, or the packed
// entry's a_full, packed_t and row_start, and l1, as above; scratch null
// (x and the residual in shared memory, `warps` columns a block) or 2 k
// floats for each of the grid's blocks * warps warps. Returns the
// cudaError_t of the launch (0 on success).
int nnls_cd_batched_wide(const float* at, const float* inv_diag,
                         const float* B, const float* X0,
                         const uint8_t* mask, const float* l1, float* X,
                         float* scratch, int n, int k, int warps, int blocks,
                         float L1, float L2, float k_div, float cap,
                         int max_sweeps, void* stream) {
  return nnls_wide_warp::launch(
      wide_args(B, X0, mask, l1, X, scratch, n, k, warps, L1, L2, k_div, cap,
                max_sweeps),
      TileGram{at, inv_diag, n, k}, blocks,
      static_cast<cudaStream_t>(stream));
}

int nnls_cd_batched_packed_wide(const float* a_full, const float* packed_t,
                                const int* row_start, const float* B,
                                const float* X0, const uint8_t* mask,
                                const float* l1, float* X, float* scratch,
                                int n, int k, int warps, int blocks, float L1,
                                float L2, float k_div, float cap,
                                int max_sweeps, void* stream) {
  return nnls_wide_warp::launch(
      wide_args(B, X0, mask, l1, X, scratch, n, k, warps, L1, L2, k_div, cap,
                max_sweeps),
      PackedGram{a_full, packed_t, row_start, n, k}, blocks,
      static_cast<cudaStream_t>(stream));
}

const char* nnls_wide_warp_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"

// Batched warm-started coordinate-descent NNLS with one Gram matrix per
// column: kernel B2 of the port, for sm_90a.
//
// Replaces singlet_tpu/ops/pallas_nnls.py `nnls_batch_pallas_batched_at`
// (kernel body `_nnls_kernel_batched`), the solve of the masked
// (cross-validation) half-updates. For every column c it computes what the
// plain version `singlet_tpu_torch.ops.nnls.nnls_batch` computes with the
// (n, k, k) Gram a = at.permute(2, 1, 0) and scalar L1:
//
//   repeat sweeps:  for i in 0..k-1:
//     diff  = b_i * inv_c[i] - L1 + L2 * x_i
//     delta = max(diff, -x_i)                    (clamp at zero)
//     x_i  += delta;  b_j -= at[i, j, c] * delta  for all j
//   tol = sum_i |x_i - x_prev_i| / (x_i + 1e-15)
//   stop when tol / k_div <= 1e-8, or sweep >= max_sweeps, or sweep >= cap
//
// b starts at the RAW right-hand side and x at X0; columns whose mask byte
// is 0 return X0 bit for bit. inv_c[i] = 1 / a_c[i, i] comes from the
// wrapper, computed by PyTorch as the plain version computes it.
//
// Design, and what bounds it. Unlike B1, the Gram is not shared: every
// column streams its own k x k Gram on every sweep (10 KB at k = 50, 40 KB
// at k = 100). The layout at[i, j, c] (as unpack_sym_from_t emits it) is
// contiguous over columns, so a column is a LANE: the 32 lanes of a warp
// read at[i, j, c0..c0+31] as one 128-byte line. This is the TPU's lane =
// column; the TPU's (k, k, block) VMEM tile is not carried over.
//
// A first version gave each column one thread that ran the whole k-step
// chain alone, one warp per 32 columns: at the bench blocks (2048 and 4096
// columns) that is one warp per SM, and its time did not move with n (2.9
// ms at both, k = 50, cap 32, NVIDIA H100 80GB HBM3 at 700 W): the chain
// of one warp, not bytes, bound it. This version took 0.9 and 1.0 ms on
// the same card. Here a block of kWarps warps shares 32 columns: warp
// w owns coordinates w, w + kWarps, ... of every column and keeps their b,
// x and 1/diag in registers. At step i the owner warp of coordinate i
// computes delta_i and publishes it in shared memory; after one barrier
// every warp downdates its own b_j. Each warp streams only its own entries
// of the Gram rows, through a ring of D rows in shared memory filled by
// cp.async (row i + D - 1 in flight while row i is consumed); only the
// thread that issued a copy reads it. The block runs until its slowest
// column stops; stopped columns idle through the barriers.
//
// Ranks above 224: eight warps of up to 28 register coordinates take
// k <= 224. Past that a block has 16 warps (512 threads) of up to 32
// coordinates each, k <= 512, with a ring of 4 rows (k <= 256) or 2: the
// same per-thread code on more warps, so the arithmetic is unchanged.
//
// Arithmetic is written with the _rn intrinsics so that nvcc contracts
// nothing into FMAs: each step rounds exactly like the plain version's
// separate elementwise kernels, and only the summation order of the sweep
// tolerance differs (per warp, then over warps). Build WITHOUT
// --use_fast_math: the clamp term x_i / 1e-15 and the tol / k <= 1e-8 exit
// need IEEE division and denormals kept.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

// cp.async (sm_80+) of 4 bytes from device to shared memory, its group
// commit and wait. The "memory" clobbers keep the compiler from moving a
// read of a ring slot past the copy that refills it.
__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n"
               :: "r"(d), "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

constexpr int kLanes = 32;       // columns per block
constexpr float kCdTol = 1e-8f;  // CD_TOL of ops/nnls.py

constexpr size_t smem_bytes(int warps, int depth, int npt) {
  // delta (2 slots), tol partials (warps), the ring: per warp D rows of
  // npt entries per lane
  return (size_t)(2 + warps + warps * depth * npt) * kLanes * sizeof(float);
}

// kWarps: warps sharing a block's coordinates; D: ring depth in Gram rows;
// NPT: coordinates per thread, k <= kWarps * NPT
template <int kWarps, int D, int NPT>
__global__ void __launch_bounds__(kLanes * kWarps)
nnls_cd_batched_kernel(const float* __restrict__ at,
                       const float* __restrict__ inv_diag,
                       const float* __restrict__ B,
                       const float* __restrict__ X0,
                       const uint8_t* __restrict__ mask,
                       float* __restrict__ X,
                       int n, int k, float L1, float L2, float k_div,
                       float cap, int max_sweeps) {
  extern __shared__ float smem[];
  const int lane = threadIdx.x;
  const int w = threadIdx.y;
  const int col = blockIdx.x * kLanes + lane;
  const bool valid = col < n;
  bool active = valid && (mask == nullptr || mask[col] != 0);
  float* delta_s = smem;                       // [2][kLanes]
  float* tol_s = delta_s + 2 * kLanes;         // [kWarps][kLanes]
  float* ring = tol_s + kWarps * kLanes +      // this thread's [D][NPT]
                (size_t)w * D * NPT * kLanes + lane;

  // coordinate q * kWarps + w of this column, in registers
  float b[NPT], x[NPT], inv[NPT];
#pragma unroll
  for (int q = 0; q < NPT; ++q) {
    const int i = q * kWarps + w;
    const bool own = valid && i < k;
    b[q] = own ? B[(size_t)col * k + i] : 0.f;
    x[q] = own ? X0[(size_t)col * k + i] : 0.f;
    inv[q] = own ? inv_diag[(size_t)i * n + col] : 0.f;
  }

  const float* at_col = at + col;
  const size_t row_stride = (size_t)k * n;     // at[i] is a (k, n) tile
  int fetch_row = 0;                           // next Gram row to fetch
  int fetch_slot = 0;                          // its ring slot
  auto fetch = [&]() {
    if (valid) {
      const float* src = at_col + (size_t)fetch_row * row_stride;
      float* dst = ring + (size_t)fetch_slot * NPT * kLanes;
#pragma unroll
      for (int q = 0; q < NPT; ++q) {
        const int j = q * kWarps + w;
        if (j < k) cp_async4(dst + q * kLanes, src + (size_t)j * n);
      }
    }
    cp_async_commit();
    fetch_row = fetch_row + 1 == k ? 0 : fetch_row + 1;
    fetch_slot = (fetch_slot + 1) & (D - 1);
  };
  for (int p = 0; p < D - 1; ++p) fetch();

  int slot = 0;   // ring slot of the row consumed at this step
  int step = 0;   // global step count: its parity picks the delta slot
  for (int sweep = 1; __syncthreads_or(active); ++sweep) {
    float tol = 0.f;
#pragma unroll
    for (int q = 0; q < NPT; ++q) {
      for (int owner = 0; owner < kWarps; ++owner, ++step) {
        const int i = q * kWarps + owner;
        if (i >= k) break;                      // uniform over the block
        fetch();   // refills the slot consumed at the previous step
        cp_async_wait<D - 1>();
        const float* a_i = ring + (size_t)slot * NPT * kLanes;
        slot = (slot + 1) & (D - 1);
        float* delta_slot = delta_s + (step & 1) * kLanes + lane;
        if (w == owner && active) {
          const float x_i = x[q];
          const float diff = __fadd_rn(
              __fsub_rn(__fmul_rn(b[q], inv[q]), L1), __fmul_rn(L2, x_i));
          const float delta = fmaxf(diff, -x_i);
          const float x_new = __fadd_rn(x_i, delta);
          x[q] = x_new;
          tol = __fadd_rn(tol, __fdiv_rn(fabsf(__fsub_rn(x_new, x_i)),
                                         __fadd_rn(x_new, 1e-15f)));
          *delta_slot = delta;
        }
        __syncthreads();
        if (active) {
          const float delta = *delta_slot;
#pragma unroll
          for (int p = 0; p < NPT; ++p) {
            if (p * kWarps + w < k) {
              b[p] = __fsub_rn(b[p], __fmul_rn(a_i[p * kLanes], delta));
            }
          }
        }
      }
    }
    tol_s[w * kLanes + lane] = tol;
    __syncthreads();
    float total = 0.f;
#pragma unroll
    for (int v = 0; v < kWarps; ++v) {
      total = __fadd_rn(total, tol_s[v * kLanes + lane]);
    }
    if (!(__fdiv_rn(total, k_div) > kCdTol) || sweep >= max_sweeps ||
        !((float)sweep < cap)) {
      active = false;
    }
  }
  cp_async_wait<0>();   // no copy may land after the block retires

  if (valid) {
#pragma unroll
    for (int q = 0; q < NPT; ++q) {
      const int i = q * kWarps + w;
      if (i < k) X[(size_t)col * k + i] = x[q];
    }
  }
}

template <int D, int NPT, int kWarps = 8>
cudaError_t launch(const float* at, const float* inv_diag, const float* B,
                   const float* X0, const uint8_t* mask, float* X, int n,
                   int k, float L1, float L2, float k_div, float cap,
                   int max_sweeps, cudaStream_t stream) {
  constexpr size_t smem = smem_bytes(kWarps, D, NPT);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        nnls_cd_batched_kernel<kWarps, D, NPT>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
  }
  const int blocks = (n + kLanes - 1) / kLanes;
  nnls_cd_batched_kernel<kWarps, D, NPT><<<blocks, dim3(kLanes, kWarps),
                                           smem, stream>>>(
      at, inv_diag, B, X0, mask, X, n, k, L1, L2, k_div, cap, max_sweeps);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// All pointers are device pointers to contiguous float32 (mask: uint8, or
// null for all columns active); at (k, k, n) with at[i, j, c] = a_c[j, i],
// inv_diag (k, n), B / X0 / X (n, k). Takes k <= 512. Returns the
// cudaError_t of the launch (0 on success).
int nnls_cd_batched(const float* at, const float* inv_diag, const float* B,
                    const float* X0, const uint8_t* mask, float* X, int n,
                    int k, float L1, float L2, float k_div, float cap,
                    int max_sweeps, void* stream) {
  if (n <= 0) return cudaSuccess;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  // coordinates per thread: the smallest instantiated NPT with
  // k <= 8 * NPT; the ring holds 8 rows, 4 at the widest k; past k = 224,
  // 16 warps
  const int npt = (k + 7) / 8;
  if (k <= 0 || k > 512) return cudaErrorInvalidValue;
  if (k > 224) {
    if (k <= 256) return launch<4, 16, 16>(at, inv_diag, B, X0, mask, X, n, k, L1, L2, k_div, cap, max_sweeps, s);
    return launch<2, 32, 16>(at, inv_diag, B, X0, mask, X, n, k, L1, L2, k_div, cap, max_sweeps, s);
  }
  if (npt <= 1) return launch<8, 1>(at, inv_diag, B, X0, mask, X, n, k, L1, L2, k_div, cap, max_sweeps, s);
  if (npt <= 2) return launch<8, 2>(at, inv_diag, B, X0, mask, X, n, k, L1, L2, k_div, cap, max_sweeps, s);
  if (npt <= 4) return launch<8, 4>(at, inv_diag, B, X0, mask, X, n, k, L1, L2, k_div, cap, max_sweeps, s);
  if (npt <= 7) return launch<8, 7>(at, inv_diag, B, X0, mask, X, n, k, L1, L2, k_div, cap, max_sweeps, s);
  if (npt <= 14) return launch<8, 14>(at, inv_diag, B, X0, mask, X, n, k, L1, L2, k_div, cap, max_sweeps, s);
  return launch<4, 28>(at, inv_diag, B, X0, mask, X, n, k, L1, L2, k_div, cap, max_sweeps, s);
}

const char* nnls_cd_batched_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"

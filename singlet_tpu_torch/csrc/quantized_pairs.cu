// The bits route's pair operands, for sm_90a: `quantized_pairs` writes the
// packed outer products of the rows of X (n, k),
//
//   P[c, p] = X[c, i] * X[c, j]   for the pairs p = (i, j), i <= j,
//
// in the row-major upper-triangle order of singlet_tpu_torch/ops/linalg.py
// `triu_pairs` (p = i k - i (i - 1) / 2 + j - i), quantized per pair into
// int8 beside a float32 scale, or rounded to bf16 beside a unit scale,
// straight into the buffer that the masked products read in place:
//
//   int8: out[p * ld + c] = q[c, p]     (the transpose of a kmajor_buffer,
//                                        B8/B13's and B9/B14's layout)
//   bf16: out[c * ld + p] = bf16(P[c, p])   (a pair_buffer)
//   both: scales[p * s_stride] = s_p (int8), 1 (bf16)
//
// It replaces no TPU kernel. The JAX package's engine runs the same chain,
// `quantize_pairs(packed_outer_products(X, iu), axis=0)`, as XLA ops
// (singlet_tpu/parallel/sharded_ell.py:885-889 and 997-999), which XLA
// fuses on the TPU; eager PyTorch ran it as about a dozen passes over an
// (n, npairs) float32 temporary, and turned the pair indices into card
// tensors with two host syncs a call. This kernel gives that chain's bits
// as PyTorch computes it on CUDA (ops/maskgram.py `quantize_pairs`):
//
//   s_p = max(max_c |P[c, p]| * (1.0f / 127.0f), 1e-30f)    (NaN kept)
//   q   = (int8) clamp(rint(P / s_p), -127, 127)             (NaN kept)
//
// P the float32 product, the divide IEEE (no fast math), rint half to even;
// PyTorch divides a tensor by a Python scalar on CUDA as a multiply by the
// scalar's float reciprocal, hence the 1.0f / 127.0f.
//
// What bounds it. The write: at a 2048-cell block and k = 100 (5050 pairs)
// 10.3 MB of int8 and 20 KB of scales, the block's H (0.8 MB) read once:
// 3.3 us at 3.35 TB/s; at the w-side's 16,384 genes 83 MB, 25 us.
//
// Design. A pair's scale needs the max over all n rows before any of its
// values is quantized. The work splits into tiles of 16 x 16 pairs (rows i
// and columns j of the triangle) times slices of the rows; the slices of one
// tile are the blocks of one thread-block cluster (up to 8), which share
// the max through distributed shared memory, so one launch does both
// sweeps and the rows need not come from device memory twice:
//
// 1. A block stages 256 rows of its tile's 16 + 16 columns of X (16 on the
//    diagonal) in shared memory, transposed (a column's rows contiguous,
//    rows of 260 floats: 16-byte loads, banks shifted by 4 a column), by
//    16-byte loads all in flight at once where X's layout allows them.
// 2. Sweep 1: warp w takes row i0 + w of the tile, a lane 4 neighbouring
//    cells of each 128, and keeps the max of |P| for its 16 pairs in
//    registers, with a max that keeps a NaN as PyTorch's amax does; a
//    shuffle reduction per pair, then the cluster's barrier, and each block
//    reads the other blocks' maxima.
// 3. Sweep 2: the same walk quantizes. A lane writes its 4 cells of a pair
//    as one 4-byte store, so a warp writes 128 neighbouring bytes of the
//    pair's K-major row. The divide is a multiply by the pair's reciprocal
//    where that gives the same integer (see `quant4`).
//
// A slice longer than the 256 staged rows is walked in chunks, staged again
// for sweep 2 (from L2). bf16 needs no max: sweep 2 alone, a warp's lanes
// on 16 neighbouring pairs of its row and two cells, no cluster.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kTile = 16;            // a tile's rows i and columns j
constexpr int kThreads = 512;        // 16 warps, one row of the tile each
constexpr int kChunk = 256;          // rows of X staged at once
constexpr int kPitch = kChunk + 4;   // floats a staged column
constexpr int kMaxCluster = 8;

struct Args {
  const float* X;
  long long ldx;      // floats between rows of X
  int n, k;
  int vec_x;          // X, ldx and k allow 16-byte loads
  void* out;
  long long ld;       // out's pitch: bytes a pair (int8), elements a row (bf16)
  int vec4;           // int8: out and ld allow 4-byte stores
  float* scales;
  long long s_stride;
  int nt;             // tiles a side, ceil(k / 16)
  int cs;             // blocks of a cluster: the slices of a tile
  int slice;          // rows a slice, a multiple of 128
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ uint32_t cluster_addr(uint32_t local,
                                                 uint32_t rank) {
  uint32_t remote;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n"
               : "=r"(remote) : "r"(local), "r"(rank));
  return remote;
}

__device__ __forceinline__ float ld_cluster_f32(uint32_t addr) {
  float v;
  asm volatile("ld.shared::cluster.f32 %0, [%1];\n"
               : "=f"(v) : "r"(addr) : "memory");
  return v;
}

// the cluster's barrier in two halves: every thread of every block arrives
// (release: its shared-memory stores before it are seen after the wait)
// and later waits (acquire)
__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

// the max that keeps a NaN, as PyTorch's amax does
__device__ __forceinline__ float max_nan(float a, float b) {
  float d;
  asm("max.NaN.f32 %0, %1, %2;\n" : "=f"(d) : "f"(a), "f"(b));
  return d;
}

// the packed index of pair (i, j), i <= j, less j
__device__ __forceinline__ long long row_base(int i, int k) {
  return (long long)i * k - (long long)i * (i - 1) / 2 - i;
}

// Rows [c0, c0 + cn) of the tile's columns i0.. (xs[0]) and, off the
// diagonal, j0.. (xs[1]) into shared memory, transposed; rows past cn and
// columns past k read 0, which no max and no write sees. 16-byte loads
// where X allows them (all in flight before the stores), else 4-byte.
__device__ __forceinline__ void stage(const Args& a,
                                      float (*xs)[kTile][kPitch], int i0,
                                      int j0, bool diag, int c0, int cn) {
  const int shift = diag ? 4 : 5;       // log2 of the staged columns
  if (a.vec_x) {
    constexpr int kLoads = 2 * kTile * kChunk / 4 / kThreads;
    float4 v[kLoads];
#pragma unroll
    for (int it = 0; it < kLoads; ++it) {
      const int idx = threadIdx.x + it * kThreads;
      const int c = idx >> (shift - 2), col = (idx & ((1 << (shift - 2)) - 1)) * 4;
      const int g = (col >= kTile ? j0 - kTile : i0) + col;
      v[it] = make_float4(0.f, 0.f, 0.f, 0.f);
      if (idx < (kChunk << (shift - 2)) && c < cn && g < a.k) {
        v[it] = *reinterpret_cast<const float4*>(
            a.X + (long long)(c0 + c) * a.ldx + g);
      }
    }
#pragma unroll
    for (int it = 0; it < kLoads; ++it) {
      const int idx = threadIdx.x + it * kThreads;
      if (idx >= (kChunk << (shift - 2))) break;
      const int c = idx >> (shift - 2), col = (idx & ((1 << (shift - 2)) - 1)) * 4;
      const int half = col >= kTile ? 1 : 0, cc = col - half * kTile;
      xs[half][cc][c] = v[it].x;
      xs[half][cc + 1][c] = v[it].y;
      xs[half][cc + 2][c] = v[it].z;
      xs[half][cc + 3][c] = v[it].w;
    }
    return;
  }
  for (int idx = threadIdx.x; idx < (kChunk << shift); idx += kThreads) {
    const int c = idx >> shift, col = idx & ((1 << shift) - 1);
    const int half = col >= kTile ? 1 : 0, cc = col - half * kTile;
    const int g = (half ? j0 : i0) + cc;
    float v = 0.f;
    if (c < cn && g < a.k) v = a.X[(long long)(c0 + c) * a.ldx + g];
    xs[half][cc][c] = v;
  }
}

// the max of |xi * xj| over 4 cells into m
__device__ __forceinline__ float max4(float m, float4 xi, float4 xj) {
  m = max_nan(m, fabsf(__fmul_rn(xi.x, xj.x)));
  m = max_nan(m, fabsf(__fmul_rn(xi.y, xj.y)));
  m = max_nan(m, fabsf(__fmul_rn(xi.z, xj.z)));
  return max_nan(m, fabsf(__fmul_rn(xi.w, xj.w)));
}

// PyTorch's clamp(rint(p / s), -127, 127).to(int8) with the IEEE divide
__device__ __forceinline__ uint32_t quant_div(float p, float s) {
  float v = rintf(__fdiv_rn(p, s));
  if (!isnan(v)) v = fminf(fmaxf(v, -127.f), 127.f);
  return static_cast<uint32_t>(static_cast<int>(static_cast<int8_t>(v)));
}

// The four quantized products of 4 cells, packed in cell order. |p| is at
// most the pair's max, so |p / s| < 127.00002 (s = max * (1 / 127), each
// rounded, or the floor), and y = p * rcp (rcp = 1 / s rounded) lies within
// 2^-15 of the rounded quotient (two roundings of 2^-24 relative). Where y
// is at least 2^-14 from a half-integer both round to the same integer,
// which adding 1.5 * 2^23 gives half to even, in [-127, 127] (no clamp),
// as the low byte of the sum's bits (the constant's low byte is 0). Near a
// tie, or where y is no finite number, the divide decides.
__device__ __forceinline__ uint32_t quant4(float4 xi, float4 xj, float s,
                                           float rcp) {
  constexpr float kMagic = 12582912.f;   // 1.5 * 2^23
  const float p[4] = {__fmul_rn(xi.x, xj.x), __fmul_rn(xi.y, xj.y),
                      __fmul_rn(xi.z, xj.z), __fmul_rn(xi.w, xj.w)};
  uint32_t b[4];
  float dmax = 0.f;
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const float y = __fmul_rn(p[e], rcp);
    const float f = __fadd_rn(y, kMagic);
    dmax = max_nan(dmax, fabsf(__fsub_rn(y, __fsub_rn(f, kMagic))));
    b[e] = __float_as_uint(f);
  }
  if (!(dmax < 0.5f - 0x1p-14f)) {
#pragma unroll
    for (int e = 0; e < 4; ++e) b[e] = quant_div(p[e], s);
  }
  return __byte_perm(__byte_perm(b[0], b[1], 0x0040),
                     __byte_perm(b[2], b[3], 0x0040), 0x5410);
}

// two blocks an SM (at most 64 registers a thread), so that the 8 x 28
// blocks of a 2048-cell block at k = 100 run in one wave
template <bool INT8>
__global__ void __launch_bounds__(kThreads, 2)
pairs_kernel(const Args a) {
  __shared__ __align__(16) float xs[2][kTile][kPitch];
  __shared__ float lmax[kTile * kTile];
  __shared__ float sc[kTile * kTile];
  __shared__ float rc[kTile * kTile];

  // the tile (ti, tj), ti <= tj, and this block's slice of the rows
  const int rank = blockIdx.x % a.cs;
  int t = blockIdx.x / a.cs, ti = 0;
  while (t >= a.nt - ti) {
    t -= a.nt - ti;
    ++ti;
  }
  const int tj = ti + t;
  const int i0 = ti * kTile, j0 = tj * kTile;
  const bool diag = ti == tj;
  const int js = diag ? 0 : 1;     // the staged half that holds the j's
  const int r0 = rank * a.slice, r1 = min(a.n, r0 + a.slice);
  const int nch = r1 > r0 ? (r1 - r0 + kChunk - 1) / kChunk : 0;
  const int ii = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int i = i0 + ii;           // this warp's row of the tile
  const int jlo = max(0, i - j0), jhi = min(kTile, a.k - j0);

  if (INT8) {
    float m[kTile];
#pragma unroll
    for (int jj = 0; jj < kTile; ++jj) m[jj] = 0.f;
    for (int ch = 0; ch < nch; ++ch) {
      const int c0 = r0 + ch * kChunk, cn = min(kChunk, r1 - c0);
      if (ch) __syncthreads();
      stage(a, xs, i0, j0, diag, c0, cn);
      __syncthreads();
#pragma unroll
      for (int g = 0; g < kChunk / 128; ++g) {
        const int cc = g * 128 + 4 * lane;
        const float4 xi = *reinterpret_cast<const float4*>(&xs[0][ii][cc]);
#pragma unroll
        for (int jj = 0; jj < kTile; ++jj) {
          m[jj] = max4(m[jj], xi,
                       *reinterpret_cast<const float4*>(&xs[js][jj][cc]));
        }
      }
    }
#pragma unroll
    for (int jj = 0; jj < kTile; ++jj) {
      float v = m[jj];
#pragma unroll
      for (int o = 16; o; o >>= 1) v = max_nan(v, __shfl_xor_sync(~0u, v, o));
      if (lane == 0) lmax[ii * kTile + jj] = v;
    }
    __syncthreads();
    cluster_arrive();
    cluster_wait();    // every block's maxima are in place
    if (threadIdx.x < kTile * kTile) {
      const int e = threadIdx.x;   // pair (e / 16, e % 16) of the tile
      const uint32_t local = smem_u32(&lmax[e]);
      float v = 0.f;
#pragma unroll
      for (int q = 0; q < kMaxCluster; ++q) {
        if (q < a.cs) {
          v = max_nan(v, ld_cluster_f32(cluster_addr(local, (uint32_t)q)));
        }
      }
      float s = __fmul_rn(v, 1.0f / 127.0f);
      if (!isnan(s)) s = fmaxf(s, 1e-30f);
      sc[e] = s;
      rc[e] = __frcp_rn(s);
      const int pi = i0 + e / kTile, pj = j0 + e % kTile;
      if (rank == 0 && pj >= pi && pj < a.k) {
        a.scales[(row_base(pi, a.k) + pj) * a.s_stride] = s;
      }
    }
    cluster_arrive();  // done reading the other blocks' maxima
    __syncthreads();

    int8_t* out = static_cast<int8_t*>(a.out);
    const long long base = row_base(i, a.k) + j0;
    for (int ch = 0; ch < nch; ++ch) {
      const int c0 = r0 + ch * kChunk, cn = min(kChunk, r1 - c0);
      if (nch > 1) {   // else sweep 1's chunk is still staged
        __syncthreads();
        stage(a, xs, i0, j0, diag, c0, cn);
        __syncthreads();
      }
      if (i >= a.k) continue;
      float4 xi[kChunk / 128];
#pragma unroll
      for (int g = 0; g < kChunk / 128; ++g) {
        xi[g] = *reinterpret_cast<const float4*>(&xs[0][ii][g * 128 + 4 * lane]);
      }
#pragma unroll 2
      for (int jj = jlo; jj < jhi; ++jj) {
        const float s = sc[ii * kTile + jj], rcp = rc[ii * kTile + jj];
        int8_t* row = out + (base + jj) * a.ld + c0;
#pragma unroll
        for (int g = 0; g < kChunk / 128; ++g) {
          const int cc = g * 128 + 4 * lane;
          if (g * 128 >= cn) break;
          const uint32_t word = quant4(
              xi[g], *reinterpret_cast<const float4*>(&xs[js][jj][cc]), s,
              rcp);
          if (a.vec4 && cc + 4 <= cn) {
            *reinterpret_cast<uint32_t*>(row + cc) = word;
          } else {
            for (int b = 0; b < 4 && cc + b < cn; ++b) {
              row[cc + b] = static_cast<int8_t>(word >> (8 * b));
            }
          }
        }
      }
    }
    cluster_wait();    // no block leaves while another reads its maxima
  } else {
    if (rank == 0 && threadIdx.x < kTile * kTile) {
      const int pi = i0 + threadIdx.x / kTile, pj = j0 + threadIdx.x % kTile;
      if (pj >= pi && pj < a.k) {
        a.scales[(row_base(pi, a.k) + pj) * a.s_stride] = 1.f;
      }
    }
    // a warp writes its row's 16 neighbouring pairs of two cells at a time
    __nv_bfloat16* out = static_cast<__nv_bfloat16*>(a.out);
    const int jj = lane & 15, sub = lane >> 4, j = j0 + jj;
    const bool live = i < a.k && j >= i && j < a.k;
    __nv_bfloat16* dst = out + (live ? row_base(i, a.k) + j : 0);
    for (int ch = 0; ch < nch; ++ch) {
      const int c0 = r0 + ch * kChunk, cn = min(kChunk, r1 - c0);
      if (ch) __syncthreads();
      stage(a, xs, i0, j0, diag, c0, cn);
      __syncthreads();
      if (!live) continue;
      for (int c = sub; c < cn; c += 2) {
        dst[(long long)(c0 + c) * a.ld] =
            __float2bfloat16(__fmul_rn(xs[0][ii][c], xs[js][jj][c]));
      }
    }
  }
}

}  // namespace

extern "C" {

// Device pointers: X (n, k) float32 rows `ldx` floats apart; out int8
// (int8 != 0) with element (c, p) at out[p * ld + c], else bf16 at
// out[c * ld + p]; scales float32 with pair p at scales[p * s_stride].
// The plan (ops/maskgram_cuda.py `pairs_plan`): clusters of cs <= 8
// blocks, slices of `slice` rows (a multiple of 128, cs * slice >= n).
// Returns the cudaError_t of the launch (0 on success).
int quantized_pairs(int int8, const float* X, long long ldx, int n, int k,
                    void* out, long long ld, float* scales,
                    long long s_stride, int cs, int slice, void* stream) {
  if (n <= 0 || k <= 0 || cs < 1 || cs > kMaxCluster || slice <= 0 ||
      slice % 128 || (long long)cs * slice < n) {
    return cudaErrorInvalidValue;
  }
  const int nt = (k + kTile - 1) / kTile;
  Args a;
  a.X = X;
  a.ldx = ldx;
  a.n = n;
  a.k = k;
  a.out = out;
  a.ld = ld;
  a.vec_x = (reinterpret_cast<uintptr_t>(X) % 16 == 0) && (ldx % 4 == 0) &&
            (k % 4 == 0);
  a.vec4 = (reinterpret_cast<uintptr_t>(out) % 4 == 0) && (ld % 4 == 0);
  a.scales = scales;
  a.s_stride = s_stride;
  a.nt = nt;
  a.cs = cs;
  a.slice = slice;
  const long long grid = (long long)nt * (nt + 1) / 2 * cs;
  if (grid > 0x7fffffffLL) return cudaErrorInvalidValue;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)grid);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = 0;
  cfg.stream = static_cast<cudaStream_t>(stream);
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cs;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = int8 ? 1 : 0;   // bf16 shares no max: no cluster
  return int8 ? cudaLaunchKernelEx(&cfg, pairs_kernel<true>, a)
              : cudaLaunchKernelEx(&cfg, pairs_kernel<false>, a);
}

const char* quantized_pairs_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"

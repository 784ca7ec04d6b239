// Blocked-ELL SpMM in both directions: kernels B3 and B4 of the port, and
// with the keep factor read from bitplane words B5 and B6, for sm_90a.
//
// B3 (`bell_spmm`) replaces singlet_tpu/ops/pallas_bell.py `bell_spmm`
// (kernel body `_spmm_kernel`), B4 (`bell_spmm_t`) replaces `bell_spmm_t`
// (`_spmm_t_kernel`); the same entry points with keep mode 2 are B5
// (`bell_spmm_bits`, `_spmm_bits_kernel`) and B6 (`bell_spmm_t_bits`,
// `_spmm_t_bits_kernel`). On planes (n_gb * width, cells) of LOCAL gene ids li
// (pad -1) and values lv (pad 0), cells contiguous with row stride `ld`:
//
//   B3:  B[c, :]  = sum over live slots (gb, w) of cell c of
//                   lv * keep * W[gb * GB + li, :]                 (cells, k)
//   B4:  Bw[g, :] = sum over the cells c with a live slot at gene g of
//                   lv * keep * H[c, :]                      (n_gb * GB, k)
//
// keep is 1 (`masked` 0); or 1 - testmask(seed, cell_offset + c, g)
// (`masked` 1): the counter hash of singlet_tpu_torch/ops/rngmask.py
// `mask_block`, bit for bit (rand(i) per cell, then the j-mix, the 64-bit
// add, the final xorshifts and `x % inv_density == 0`), on native uint64;
// or (`masked` 2, B5 and B6) 1 - the test bit of (c, g) in the packed words
// of singlet_tpu_torch/ops/maskbits.py, words[c, (gb >> 5) * GB + li] >>
// (gb & 31) & 1, one load and one shift per slot in place of the hash.
// Pad slots are skipped: the TPU kernel multiplies them out, hashing a
// bogus gene id. The three modes differ only in which slots are skipped,
// so B5 gives the bits of B3 with the hash, and B6 those of B4, whenever
// the words hold the same mask.
//
// Design, and what bounds it. The TPU densifies each (gene block, 256
// cells) tile by a one-hot multiply-compare-sum because it has no gather,
// and then runs the dense product on the matrix unit. Hopper gathers, so
// both kernels touch only the nonzeros: at 524,288 cells x 16,384 genes,
// k = 100, 5% dense, that is 420M nonzeros x k = 84 GFLOP against 1.7 TFLOP
// for the densified tiles. Neither is bound by device-memory bytes (the
// planes, 4.3 GB, are read once per k-slice at most); the bound is the
// number of gathered rows moved through L1/L2 and shared memory per
// nonzero, k floats each.
//
// B3: one warp per cell. Lane l reads slot w0 + l of the cell (the eight
// warps of a block take eight neighbouring cells, so a 32-byte sector of a
// plane row serves the whole block from L1), hashes its own slot, and the
// warp then walks the live slots in order: each one broadcast by shuffle,
// the lanes gather W's row (coalesced, k floats; W is 6.5 MB at k=100 and
// stays in L2) and accumulate the cell's k outputs in registers. Each
// output is one thread's sum in a fixed order: deterministic. A lane holds
// at most 7 outputs (k <= 224); the wrapper (ops/bell_cuda.py) launches a
// wider W in column chunks of at most 224, which gives the same sums, since
// no output's sum depends on the other columns.
//
// B4: the scatter direction, made deterministic without atomics. A block
// owns (gene block gb, a 32-column slice of k, a chunk of cells) and keeps
// the (gene_block, 32) accumulator tile in shared memory. It stages 32
// slots x 32 cells of the planes at a time (hashing each entry once), and
// each of its sixteen warps owns a sixteenth of the gene block's rows: it
// walks the staged tile in a fixed order, and for each entry that falls in
// its rows the lanes add lv * H[c, k0 + lane] into their own column of
// that row. Every accumulator element is written by exactly one thread in
// a fixed order. Chunks of cells give the card enough blocks; their
// partial tiles go to a (n_chunks, genes, k) buffer that a second kernel
// sums in chunk order. The chunking depends only on the shapes, so the
// result is the same bits on every run.
//
// Arithmetic is float32 (fused multiply-adds); build without
// --use_fast_math. Only the order of the sums differs from the plain
// PyTorch versions.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kWarps = 8;                       // B3: warps (cells) per block
constexpr int kWarpsT = 16;                     // B4: warps per block
constexpr int kStage = 32;                      // B4: staged slots x cells

__device__ __forceinline__ uint64_t hash_i(uint64_t seed, uint64_t i) {
  i ^= i << 19;
  i ^= i >> 7;
  i ^= i << 36;
  uint64_t x = seed + i;
  x ^= x << 38;
  x ^= x >> 13;
  x ^= x << 23;
  return x;
}

__device__ __forceinline__ bool held_out(uint64_t xi, uint64_t j,
                                         uint64_t inv_density) {
  j ^= j >> 7;
  j ^= j << 23;
  j ^= j >> 8;
  uint64_t x = xi + j;
  x ^= x >> 7;
  x ^= x << 53;
  x ^= x >> 4;
  return x % inv_density == 0;
}

// global cell and gene ids enter the hash as uint32, as in rngmask.py
__device__ __forceinline__ uint64_t cell_hash(uint64_t seed,
                                              long long cell_id) {
  return hash_i(seed, (uint64_t)(uint32_t)cell_id);
}

// keep mode 2: whether the packed words hold cell c's test bit at gene
// block gb, local gene l (`wrow` is cell c's row of words)
__device__ __forceinline__ bool word_bit(const uint32_t* __restrict__ wrow,
                                         int gb, int gene_block, int l) {
  return (wrow[(gb >> 5) * gene_block + l] >> (gb & 31)) & 1u;
}

template <int NPL>  // output columns per lane: k <= 32 * NPL
__global__ void __launch_bounds__(kWarps * 32)
bell_spmm_kernel(const int32_t* __restrict__ li, const float* __restrict__ lv,
                 long long ld, int n_gb, int width, int cells,
                 int gene_block, const float* __restrict__ W, int k,
                 float* __restrict__ B, int masked, uint64_t seed,
                 long long cell_offset, uint64_t inv_density,
                 const uint32_t* __restrict__ words, long long wld) {
  const int lane = threadIdx.x & 31;
  const long long c = (long long)blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (c >= cells) return;  // whole warps only
  const uint64_t xi = masked == 1 ? cell_hash(seed, cell_offset + c) : 0;
  const uint32_t* wrow = masked == 2 ? words + c * wld : nullptr;
  float acc[NPL];
#pragma unroll
  for (int s = 0; s < NPL; ++s) acc[s] = 0.f;

  for (int gb = 0; gb < n_gb; ++gb) {
    for (int w0 = 0; w0 < width; w0 += 32) {
      const int w = w0 + lane;
      int g = -1;
      float v = 0.f;
      if (w < width) {
        const long long off = (long long)(gb * width + w) * ld + c;
        const int l = li[off];
        if (l >= 0) {
          g = gb * gene_block + l;
          v = lv[off];
          if ((masked == 1 &&
               held_out(xi, (uint64_t)(uint32_t)g, inv_density)) ||
              (masked == 2 && word_bit(wrow, gb, gene_block, l))) {
            g = -1;  // held out: keep = 0, the entry adds nothing
          }
        }
      }
      unsigned live = __ballot_sync(kFull, g >= 0);
      while (live) {
        const int j = __ffs(live) - 1;
        live &= live - 1;
        const int gj = __shfl_sync(kFull, g, j);
        const float vj = __shfl_sync(kFull, v, j);
        const float* w_row = W + (long long)gj * k;
#pragma unroll
        for (int s = 0; s < NPL; ++s) {
          const int col = s * 32 + lane;
          if (col < k) acc[s] = fmaf(vj, w_row[col], acc[s]);
        }
      }
    }
  }
  float* b_row = B + c * k;
#pragma unroll
  for (int s = 0; s < NPL; ++s) {
    const int col = s * 32 + lane;
    if (col < k) b_row[col] = acc[s];
  }
}

__global__ void __launch_bounds__(kWarpsT * 32)
bell_spmm_t_kernel(const int32_t* __restrict__ li,
                   const float* __restrict__ lv, long long ld, int n_gb,
                   int width, int cells, int gene_block,
                   const float* __restrict__ H, int k,
                   float* __restrict__ out, int chunk, int masked,
                   uint64_t seed, long long cell_offset,
                   uint64_t inv_density, const uint32_t* __restrict__ words,
                   long long wld) {
  extern __shared__ float smem[];
  float* acc = smem;                                   // (gene_block, 32)
  int* s_l = reinterpret_cast<int*>(acc + gene_block * 32);  // (32, 32)
  float* s_v = reinterpret_cast<float*>(s_l + kStage * 32);  // (32, 32)
  float* s_h = s_v + kStage * 32;                      // (32 cells, 32 cols)

  const int gb = blockIdx.x;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int col = blockIdx.y * 32 + lane;
  // this warp's rows of the gene block
  const int g_lo = (warp * gene_block) / kWarpsT;
  const int g_hi = ((warp + 1) * gene_block) / kWarpsT;

  for (int i = threadIdx.x; i < gene_block * 32; i += kWarpsT * 32) {
    acc[i] = 0.f;
  }
  const long long c_begin = (long long)blockIdx.z * chunk;
  const long long c_end = min((long long)cells, c_begin + chunk);

  for (long long c0 = c_begin; c0 < c_end; c0 += 32) {
    // staging: thread (warp, lane) takes cell c0 + lane, slots warp + 16 i
    const long long c = c0 + lane;
    const bool c_ok = c < c_end;
    const uint64_t xi = (masked == 1 && c_ok)
                            ? cell_hash(seed, cell_offset + c) : 0;
    const uint32_t* wrow = (masked == 2 && c_ok) ? words + c * wld : nullptr;
    __syncthreads();  // the previous H tile is consumed, acc is zeroed
#pragma unroll
    for (int i = 0; i < 32 / kWarpsT; ++i) {
      const int j = warp + kWarpsT * i;
      s_h[j * 32 + lane] = (c0 + j < c_end && col < k) ? H[(c0 + j) * k + col]
                                                        : 0.f;
    }
    for (int w0 = 0; w0 < width; w0 += kStage) {
      if (w0 > 0) __syncthreads();  // the previous slot tile is consumed
#pragma unroll
      for (int i = 0; i < kStage / kWarpsT; ++i) {
        const int rr = warp + kWarpsT * i;
        const int w = w0 + rr;
        int l = -1;
        float v = 0.f;
        if (c_ok && w < width) {
          const long long off = (long long)(gb * width + w) * ld + c;
          l = li[off];
          if (l >= 0) {
            v = lv[off];
            if ((masked == 1 &&
                 held_out(xi, (uint64_t)(uint32_t)(gb * gene_block + l),
                          inv_density)) ||
                (masked == 2 && word_bit(wrow, gb, gene_block, l))) {
              l = -1;
            }
          }
        }
        s_l[rr * 32 + lane] = l;
        s_v[rr * 32 + lane] = v;
      }
      __syncthreads();
      for (int rr = 0; rr < kStage; ++rr) {
        const int l = s_l[rr * 32 + lane];
        const float v = s_v[rr * 32 + lane];
        unsigned hit = __ballot_sync(kFull, l >= g_lo && l < g_hi);
        while (hit) {
          const int j = __ffs(hit) - 1;
          hit &= hit - 1;
          const int lj = __shfl_sync(kFull, l, j);
          const float vj = __shfl_sync(kFull, v, j);
          float* a = acc + lj * 32 + lane;
          *a = fmaf(vj, s_h[j * 32 + lane], *a);
        }
      }
    }
  }
  __syncthreads();
  float* o = out + (long long)blockIdx.z * ((long long)n_gb * gene_block * k);
  for (int i = threadIdx.x; i < gene_block * 32; i += kWarpsT * 32) {
    const int g = i >> 5;
    const int cc = blockIdx.y * 32 + (i & 31);
    if (cc < k) o[((long long)gb * gene_block + g) * k + cc] = acc[i];
  }
}

// out[i] = sum over chunks, in chunk order, of partials[chunk, i]
__global__ void sum_chunks_kernel(const float* __restrict__ partials,
                                  int n_chunks, long long size,
                                  float* __restrict__ out) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= size) return;
  float s = partials[i];
  for (int ch = 1; ch < n_chunks; ++ch) s += partials[ch * size + i];
  out[i] = s;
}

template <int NPL>
cudaError_t launch_b3(const int32_t* li, const float* lv, long long ld,
                      int n_gb, int width, int cells, int gene_block,
                      const float* W, int k, float* B, int masked,
                      uint64_t seed, long long cell_offset,
                      uint64_t inv_density, const uint32_t* words,
                      long long wld, cudaStream_t stream) {
  const int blocks = (cells + kWarps - 1) / kWarps;
  bell_spmm_kernel<NPL><<<blocks, kWarps * 32, 0, stream>>>(
      li, lv, ld, n_gb, width, cells, gene_block, W, k, B, masked, seed,
      cell_offset, inv_density, words, wld);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Device pointers: li int32 / lv float32 planes, row r at r * ld; W
// (n_gb * gene_block, k) and B (cells, k) contiguous float32. `masked`: 0
// keep all, 1 hash (seed, cell_offset, inv_density), 2 words (cells rows of
// row stride `wld`, the packed test mask of these cells). Returns the
// cudaError_t of the launch (0 on success).
int bell_spmm(const int32_t* li, const float* lv, long long ld, int n_gb,
              int width, int cells, int gene_block, const float* W, int k,
              float* B, int masked, uint64_t seed, long long cell_offset,
              int inv_density, const uint32_t* words, long long wld,
              void* stream) {
  if (cells <= 0 || k <= 0) return cudaSuccess;
  if (inv_density < 1 || masked < 0 || masked > 2 ||
      (masked == 2 && words == nullptr)) {
    return cudaErrorInvalidValue;
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const uint64_t d = (uint64_t)inv_density;
  switch ((k + 31) / 32) {
    case 1: return launch_b3<1>(li, lv, ld, n_gb, width, cells, gene_block, W, k, B, masked, seed, cell_offset, d, words, wld, s);
    case 2: return launch_b3<2>(li, lv, ld, n_gb, width, cells, gene_block, W, k, B, masked, seed, cell_offset, d, words, wld, s);
    case 3: return launch_b3<3>(li, lv, ld, n_gb, width, cells, gene_block, W, k, B, masked, seed, cell_offset, d, words, wld, s);
    case 4: return launch_b3<4>(li, lv, ld, n_gb, width, cells, gene_block, W, k, B, masked, seed, cell_offset, d, words, wld, s);
    case 5: return launch_b3<5>(li, lv, ld, n_gb, width, cells, gene_block, W, k, B, masked, seed, cell_offset, d, words, wld, s);
    case 6: return launch_b3<6>(li, lv, ld, n_gb, width, cells, gene_block, W, k, B, masked, seed, cell_offset, d, words, wld, s);
    case 7: return launch_b3<7>(li, lv, ld, n_gb, width, cells, gene_block, W, k, B, masked, seed, cell_offset, d, words, wld, s);
    default: return cudaErrorInvalidValue;
  }
}

// As bell_spmm, with H (cells, k) and Bw (n_gb * gene_block, k). With
// n_chunks > 1, `partials` holds (n_chunks, n_gb * gene_block, k) floats
// of scratch and a second launch sums them into Bw; with n_chunks == 1 the
// first launch writes Bw and `partials` is unused. `chunk` (a multiple of
// 32) is the cells per chunk.
int bell_spmm_t(const int32_t* li, const float* lv, long long ld, int n_gb,
                int width, int cells, int gene_block, const float* H, int k,
                float* partials, int n_chunks, int chunk, float* Bw,
                int masked, uint64_t seed, long long cell_offset,
                int inv_density, const uint32_t* words, long long wld,
                void* stream) {
  if (k <= 0 || n_gb <= 0) return cudaSuccess;
  if (inv_density < 1 || n_chunks < 1 || chunk % 32 != 0 || masked < 0 ||
      masked > 2 || (masked == 2 && words == nullptr)) {
    return cudaErrorInvalidValue;
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const size_t smem = ((size_t)gene_block * 32 + (size_t)kStage * 32 * 3) *
                      sizeof(float);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        bell_spmm_t_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return err;
  }
  float* first = n_chunks == 1 ? Bw : partials;
  const dim3 grid(n_gb, (k + 31) / 32, n_chunks);
  bell_spmm_t_kernel<<<grid, kWarpsT * 32, smem, s>>>(
      li, lv, ld, n_gb, width, cells, gene_block, H, k, first, chunk, masked,
      seed, cell_offset, (uint64_t)inv_density, words, wld);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || n_chunks == 1) return err;
  const long long size = (long long)n_gb * gene_block * k;
  const int threads = 256;
  const long long blocks = (size + threads - 1) / threads;
  sum_chunks_kernel<<<(unsigned)blocks, threads, 0, s>>>(partials, n_chunks,
                                                         size, Bw);
  return cudaGetLastError();
}

const char* bell_spmm_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"

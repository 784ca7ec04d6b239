// Fused held-out test MSE sums over blocked-ELL planes and bitplane words:
// kernel B7 of the port, for sm_90a.
//
// Replaces singlet_tpu/ops/pallas_bell.py `bell_mse_bits` (kernel body
// `_mse_kernel`). Per cell c, over the genes g its test mask holds out
// (mask(c, g) = words[c, (gb >> 5) * GB + w] >> (gb & 31) & 1, g = gb * GB
// + w, singlet_tpu_torch/ops/maskbits.py):
//
//   out[0, c] = sum of (H[c, :] . Wd[g, :] - A(c, g))^2
//   out[1, c] = their count
//
// A(c, g) is the value of the live slot of cell c at local gene w of gene
// block gb in the planes (li, lv), or 0 where there is none.
//
// Design, and what bounds it. The TPU densifies every (gene block x
// cells) tile and predicts all of it on its matrix unit, because it cannot
// gather. Only the held-out entries count (1 / inv_density of them, 5% at
// the default 20), so this kernel predicts only those: at 524,288 cells x
// 16,384 genes, k = 100, 430M entries, 86 GFLOP (1.3 ms at the 67 TFLOP/s
// float32 peak), against about 5.2 GiB of planes, words and H to read
// (1.7 ms at 3.35 TB/s): bound by memory. One warp per cell, eight cells a
// block. The warp holds H[c, :] in registers (lane l: columns l, l + 32,
// ...). Per gene block it scatters the cell's live slots into a dense
// (gene_block) row of its own in shared memory, so that a held-out gene's
// value is one shared load; then it reads the cell's words of that block's
// word group (each lane a word, coalesced), ballots the held-out bit, and
// for each held-out gene the lanes form the dot with Wd's row (coalesced,
// Wd stays in L2) and reduce it by shuffles. Lane 0's sums are written;
// the order is fixed, so a run gives the same bits every time. It clears
// the slots it wrote before the next gene block.
//
// H columns per lane are a template parameter: 1..7 (k <= 224), then 8, 12
// and 16 (k <= 512).
//
// The sums run in another order than the plain version's (which densifies
// and predicts everything); float32, fused multiply-adds, built without
// --use_fast_math.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kWarps = 8;  // cells per block

template <int NPL>  // H columns per lane: k <= 32 * NPL
__global__ void __launch_bounds__(kWarps * 32)
bell_mse_bits_kernel(const int32_t* __restrict__ li,
                     const float* __restrict__ lv, long long ld, int n_gb,
                     int width, int cells, int gene_block,
                     const uint32_t* __restrict__ words, long long wld,
                     const float* __restrict__ Wd,
                     const float* __restrict__ H, int k,
                     float* __restrict__ out) {
  extern __shared__ float dense_all[];  // (kWarps, gene_block)
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  float* dense = dense_all + (long long)warp * gene_block;
  for (int i = lane; i < gene_block; i += 32) dense[i] = 0.f;
  __syncwarp();
  const long long c = (long long)blockIdx.x * kWarps + warp;
  if (c >= cells) return;  // whole warps only; no block barrier follows

  float h[NPL];
#pragma unroll
  for (int s = 0; s < NPL; ++s) {
    const int col = s * 32 + lane;
    h[s] = col < k ? H[c * k + col] : 0.f;
  }
  const uint32_t* wrow = words + c * wld;
  float s_sum = 0.f, n_sum = 0.f;

  for (int gb = 0; gb < n_gb; ++gb) {
    // this cell's live slots of gene block gb -> the dense row
    for (int w0 = 0; w0 < width; w0 += 32) {
      const int w = w0 + lane;
      if (w < width) {
        const long long off = (long long)(gb * width + w) * ld + c;
        const int l = li[off];
        if (l >= 0) dense[l] = lv[off];
      }
    }
    __syncwarp();
    const uint32_t* wg = wrow + (gb >> 5) * gene_block;
    const int shift = gb & 31;
    for (int w0 = 0; w0 < gene_block; w0 += 32) {
      const int w = w0 + lane;
      const bool held = w < gene_block && ((wg[w] >> shift) & 1u);
      unsigned hit = __ballot_sync(kFull, held);
      while (hit) {
        const int l = w0 + __ffs(hit) - 1;
        hit &= hit - 1;
        const float* wd = Wd + ((long long)gb * gene_block + l) * k;
        float p = 0.f;
#pragma unroll
        for (int s = 0; s < NPL; ++s) {
          const int col = s * 32 + lane;
          if (col < k) p = fmaf(h[s], wd[col], p);
        }
#pragma unroll
        for (int o = 16; o > 0; o >>= 1) p += __shfl_xor_sync(kFull, p, o);
        const float diff = p - dense[l];
        s_sum = fmaf(diff, diff, s_sum);
        n_sum += 1.f;
      }
    }
    __syncwarp();
    for (int w0 = 0; w0 < width; w0 += 32) {
      const int w = w0 + lane;
      if (w < width) {
        const int l = li[(long long)(gb * width + w) * ld + c];
        if (l >= 0) dense[l] = 0.f;
      }
    }
    __syncwarp();
  }
  if (lane == 0) {
    out[c] = s_sum;
    out[cells + c] = n_sum;
  }
}

template <int NPL>
cudaError_t launch(const int32_t* li, const float* lv, long long ld, int n_gb,
                   int width, int cells, int gene_block,
                   const uint32_t* words, long long wld, const float* Wd,
                   const float* H, int k, float* out, cudaStream_t stream) {
  const size_t smem = (size_t)kWarps * gene_block * sizeof(float);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        bell_mse_bits_kernel<NPL>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
  }
  const int blocks = (cells + kWarps - 1) / kWarps;
  bell_mse_bits_kernel<NPL><<<blocks, kWarps * 32, smem, stream>>>(
      li, lv, ld, n_gb, width, cells, gene_block, words, wld, Wd, H, k, out);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Device pointers: li int32 / lv float32 planes, row r at r * ld; words
// (cells rows of stride wld) uint32; Wd (n_gb * gene_block, k) and H
// (cells, k) contiguous float32; out (2, cells) float32. Returns the
// cudaError_t of the launch (0 on success).
int bell_mse_bits(const int32_t* li, const float* lv, long long ld, int n_gb,
                  int width, int cells, int gene_block, const uint32_t* words,
                  long long wld, const float* Wd, const float* H, int k,
                  float* out, void* stream) {
  if (cells <= 0) return cudaSuccess;
  if (k <= 0 || gene_block <= 0) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch ((k + 31) / 32) {
    case 1: return launch<1>(li, lv, ld, n_gb, width, cells, gene_block, words, wld, Wd, H, k, out, s);
    case 2: return launch<2>(li, lv, ld, n_gb, width, cells, gene_block, words, wld, Wd, H, k, out, s);
    case 3: return launch<3>(li, lv, ld, n_gb, width, cells, gene_block, words, wld, Wd, H, k, out, s);
    case 4: return launch<4>(li, lv, ld, n_gb, width, cells, gene_block, words, wld, Wd, H, k, out, s);
    case 5: return launch<5>(li, lv, ld, n_gb, width, cells, gene_block, words, wld, Wd, H, k, out, s);
    case 6: return launch<6>(li, lv, ld, n_gb, width, cells, gene_block, words, wld, Wd, H, k, out, s);
    case 7: return launch<7>(li, lv, ld, n_gb, width, cells, gene_block, words, wld, Wd, H, k, out, s);
    default: break;
  }
  // k > 224: a wider H row per lane (the columns past k add nothing, so the
  // sums are those of a template of exactly ceil(k / 32))
  const int npl = (k + 31) / 32;
  if (npl <= 8) return launch<8>(li, lv, ld, n_gb, width, cells, gene_block, words, wld, Wd, H, k, out, s);
  if (npl <= 12) return launch<12>(li, lv, ld, n_gb, width, cells, gene_block, words, wld, Wd, H, k, out, s);
  if (npl <= 16) return launch<16>(li, lv, ld, n_gb, width, cells, gene_block, words, wld, Wd, H, k, out, s);
  return cudaErrorInvalidValue;
}

const char* bell_mse_bits_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"

// The warp-a-cell kernel of B7's wide route as it was before the tiles
// of cells (csrc/bell_mse_bits.cu `b7_wide_kernel`) replaced it up to k =
// 1024 (and, with Wd's rows streamed and the slots walked in passes, past
// k = 1024 and on wide gene blocks, where bell_mse_bits.cu kept the same
// kernel until then): its kernel and its entry, from bell_mse_bits.cu. No
// route of the package calls it: ab_bell_mse.py (`--wide`, and
// chip_smoke.py phases 10b and 10c through it) times the tiles against it
// in turns on the same inputs, and the card tests hold the two to the same
// bits; this copy keeps the code as it was compiled before, in one source
// of its own.
//
// A warp owns a cell and walks its gene blocks in order and each one's
// sub-blocks of 512 genes in order: it writes the cell's live slots of the
// sub-block into a tagged row of (tag, value) pairs in shared memory (a
// stale tag reads as 0), reads the cell's words in place (a lane per gene,
// the held-out genes of 32 by one ballot), and for each held-out gene in
// ascending order forms the dot of H's row with Wd's row, both read from
// device memory (through L1 and L2): lane l's fmaf chain over its columns
// l, l + 32, ... in order, then the xor butterfly 16, 8, 4, 2, 1. What
// bounds it: Wd's row and H's row from L1/L2 for every held-out entry, 2 k
// floats, with one lane-wide fmaf per 32 of them.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr unsigned kFull = 0xffffffffu;

// ------------------------------------------------------- the wide route

constexpr int kWideWarps = 8;     // cells a block of the wide route
constexpr int kWideRows = 512;    // genes a sub-block of the wide route

struct WideArgs {
  const int32_t* li;     // planes, row r at r * ld
  const float* lv;
  long long ld;
  int n_gb, width, cells, gene_block;
  const uint32_t* words; // (cells, n_t gene_block), rows of stride wld
  long long wld;
  const float* Wd;       // (n_gb * gene_block, k)
  const float* H;        // (cells, k)
  int k;
  float* out;            // (2, cells)
};

__global__ void __launch_bounds__(kWideWarps * 32)
b7_wide_kernel(const WideArgs a) {
  __shared__ uint2 rows_s[kWideWarps * kWideRows];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const long long c = (long long)blockIdx.x * kWideWarps + warp;
  if (c >= a.cells) return;   // whole warps only
  uint2* dense = rows_s + warp * kWideRows;
  for (int i = lane; i < kWideRows; i += 32) dense[i] = make_uint2(0u, 0u);
  __syncwarp();
  const float* h = a.H + c * a.k;
  const uint32_t* wrow = a.words + c * a.wld;
  unsigned tag = 0;
  float s = 0.f, n = 0.f;
  for (int gb = 0; gb < a.n_gb; ++gb) {
    for (int g0 = 0; g0 < a.gene_block; g0 += kWideRows) {
      const int rows = min(kWideRows, a.gene_block - g0);
      ++tag;
      // the cell's live slots of the sub-block into the tagged row
      for (int w = lane; w < a.width; w += 32) {
        const long long off = (long long)(gb * a.width + w) * a.ld + c;
        const int l = a.li[off] - g0;
        if (l >= 0 && l < rows) {
          dense[l] = make_uint2(tag, __float_as_uint(a.lv[off]));
        }
      }
      __syncwarp();
      for (int w0 = 0; w0 < rows; w0 += 32) {
        const int l = g0 + w0 + lane;
        const bool held =
            w0 + lane < rows &&
            ((__ldg(wrow + (gb >> 5) * a.gene_block + l) >> (gb & 31)) & 1u);
        unsigned m = __ballot_sync(kFull, held);
        while (m) {
          const int j = __ffs(m) - 1;
          m &= m - 1;
          const float* wd = a.Wd + ((long long)gb * a.gene_block + g0 + w0 +
                                    j) * a.k;
          float acc = 0.f;
          for (int col = lane; col < a.k; col += 32) {
            acc = fmaf(__ldg(h + col), __ldg(wd + col), acc);
          }
#pragma unroll
          for (int off = 16; off >= 1; off >>= 1) {
            acc += __shfl_xor_sync(kFull, acc, off);
          }
          const uint2 at = dense[w0 + j];
          const float a_l = at.x == tag ? __uint_as_float(at.y) : 0.f;
          const float diff = acc - a_l;
          s = fmaf(diff, diff, s);
          n += 1.f;   // counts below 2^24: exact
        }
      }
      __syncwarp();   // the row is read before the next sub-block's writes
    }
  }
  if (lane == 0) {
    a.out[c] = s;
    a.out[a.cells + c] = n;
  }
}

}  // namespace

extern "C" {

// The wide route, for any k and any gene block: words (cells rows of
// stride wld) read in place (no pass, no scratch), Wd (n_gb * gene_block,
// k) and H (cells, k) contiguous float32 as they are; the other arguments
// as bell_mse_bits'. Returns the cudaError_t of the launch (0 on success).
int bell_mse_bits_wide(const int32_t* li, const float* lv, long long ld,
                       int n_gb, int width, int cells, int gene_block,
                       const uint32_t* words, long long wld, const float* Wd,
                       const float* H, int k, float* out, void* stream) {
  if (cells <= 0) return cudaSuccess;
  const long long blocks = (cells + kWideWarps - 1) / kWideWarps;
  if (k <= 0 || gene_block <= 0 || n_gb <= 0 || width <= 0 ||
      blocks > 0x7fffffffLL) {
    return cudaErrorInvalidValue;
  }
  WideArgs a{};
  a.li = li;
  a.lv = lv;
  a.ld = ld;
  a.n_gb = n_gb;
  a.width = width;
  a.cells = cells;
  a.gene_block = gene_block;
  a.words = words;
  a.wld = wld;
  a.Wd = Wd;
  a.H = H;
  a.k = k;
  a.out = out;
  b7_wide_kernel<<<(unsigned)blocks, kWideWarps * 32, 0,
                   static_cast<cudaStream_t>(stream)>>>(a);
  return cudaGetLastError();
}

const char* bell_mse_bits_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"

// The one-warp-per-cell kernel of B3 and B5 on wide gene blocks that
// csrc/bell_spmm.cu's wide-block route (`bell_spmm_wide`) replaced, kept
// as it was so that chip_smoke.py and ab_bell_spmm.py can time the two in
// turns on one card. Not part of any fit.
//
// A warp owns a cell and a column chunk of up to 256 columns and reads W's
// rows from device memory (through L1 and L2): lane l reads slot w0 + l of
// the cell, keep-tests it (the hash, or the bit of the packed words read
// in place), and the warp walks the kept slots in slot order, each
// broadcast by shuffle, every lane adding v * W[g, j] into its 8 columns
// j = j0 + l + 32 s. Every output is one lane's fmaf chain over the cell's
// gene blocks in order and, in each, its kept slots in slot order: the
// bits of csrc/bell_spmm.cu's kernels. What bounds it: each kept slot's W
// row from L2 waits on the one before (the fmaf chain), about 800 slots a
// cell in series.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

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

// global cell and gene ids enter the hash as uint32, as in rngmask.py
__device__ __forceinline__ uint64_t cell_hash(uint64_t seed,
                                              long long cell_id) {
  return hash_i(seed, (uint64_t)(uint32_t)cell_id);
}

// whether slot (cell, gene gb * gene_block + l) is kept in keep mode MODE:
// `xi` is the cell's hash (mode 1), `word` its packed test-mask word of l
// (mode 2); `a` is a B3WideArgs
template <int MODE, typename Args>
__device__ __forceinline__ bool slot_kept(const Args& a, int gb, uint64_t xi,
                                          int l, uint32_t word) {
  if (MODE == 1) {
    // the gene mix of rngmask.py, then `x % inv_density == 0` as a multiply
    uint64_t j = (uint64_t)(uint32_t)(gb * a.gene_block + l);
    j ^= j >> 7;
    j ^= j << 23;
    j ^= j >> 8;
    uint64_t x = xi + j;
    x ^= x >> 7;
    x ^= x << 53;
    x ^= x >> 4;
    return (x & ((1ull << a.shift) - 1)) != 0 ||
           x * a.odd_inverse > a.odd_limit;
  }
  return MODE != 2 || !((word >> (gb & 31)) & 1u);
}

// x % d == 0 as a multiply (Granlund and Montgomery): with d = odd <<
// shift, x is a multiple iff its low `shift` bits are 0 and x * odd^-1 mod
// 2^64 <= (2^64 - 1) / odd
struct OddDivisor {
  int shift;
  uint64_t inverse;
  uint64_t limit;
};

OddDivisor odd_divisor(uint64_t d) {
  int shift = 0;
  while (!(d & 1)) {
    d >>= 1;
    ++shift;
  }
  uint64_t inverse = d;  // Newton: each step doubles the correct bits
  for (int i = 0; i < 5; ++i) inverse *= 2 - d * inverse;
  return {shift, inverse, ~0ull / d};
}

constexpr unsigned kFull = 0xffffffffu;
constexpr int kWideWarps = 8;     // cells a block of the wide-block route
constexpr int kWideNpl = 8;       // columns a lane: chunks of 256 columns

// the fields `slot_kept` reads, and the route's own
struct B3WideArgs {
  const int32_t* li;
  const float* lv;
  long long ld;
  int n_gb, width, cells, gene_block;
  const float* W;
  long long ldw;
  int k;
  float* B;
  uint64_t seed;
  long long cell_offset;
  int shift;
  uint64_t odd_inverse;
  uint64_t odd_limit;
  const uint32_t* words;
  long long wld;
};

template <int MODE>
__global__ void __launch_bounds__(kWideWarps * 32)
bell_spmm_wide_kernel(const B3WideArgs a) {
  const int lane = threadIdx.x & 31;
  const long long c = (long long)blockIdx.x * kWideWarps + (threadIdx.x >> 5);
  if (c >= a.cells) return;   // whole warps only
  const int j0 = blockIdx.y * 32 * kWideNpl;
  const uint64_t xi = MODE == 1 ? cell_hash(a.seed, a.cell_offset + c) : 0;
  const uint32_t* wrow = MODE == 2 ? a.words + c * a.wld : nullptr;
  float acc[kWideNpl];
#pragma unroll
  for (int s = 0; s < kWideNpl; ++s) acc[s] = 0.f;
  for (int gb = 0; gb < a.n_gb; ++gb) {
    for (int w0 = 0; w0 < a.width; w0 += 32) {
      const int w = w0 + lane;
      int g = -1;
      float v = 0.f;
      if (w < a.width) {
        const long long off = (long long)(gb * a.width + w) * a.ld + c;
        const int l = a.li[off];
        if (l >= 0) {
          const uint32_t word =
              MODE == 2 ? wrow[(gb >> 5) * a.gene_block + l] : 0u;
          if (slot_kept<MODE>(a, gb, xi, l, word)) {
            g = gb * a.gene_block + l;
            v = a.lv[off];
          }
        }
      }
      unsigned live = __ballot_sync(kFull, g >= 0);
      while (live) {
        const int j = __ffs(live) - 1;
        live &= live - 1;
        const int gj = __shfl_sync(kFull, g, j);
        const float vj = __shfl_sync(kFull, v, j);
        const float* w_row = a.W + (long long)gj * a.ldw;
#pragma unroll
        for (int s = 0; s < kWideNpl; ++s) {
          const int col = j0 + s * 32 + lane;
          if (col < a.k) acc[s] = fmaf(vj, __ldg(w_row + col), acc[s]);
        }
      }
    }
  }
  float* b_row = a.B + c * a.k;
#pragma unroll
  for (int s = 0; s < kWideNpl; ++s) {
    const int col = j0 + s * 32 + lane;
    if (col < a.k) b_row[col] = acc[s];
  }
}

}  // namespace

extern "C" {

// The wide-block route of B3 (keep mode 0 or 1) and B5 (mode 2), for any
// gene block and any k: a warp per cell and column chunk of 256, W's rows
// read from device memory (W (n_gb * gene_block, k), row stride ldw), the
// words read in place (no pass). The other arguments as those of
// csrc/bell_spmm.cu's bell_spmm.
// Returns the cudaError_t of the launch (0 on success).
int bell_spmm_wide(const int32_t* li, const float* lv, long long ld,
                   int n_gb, int width, int cells, int gene_block,
                   const float* W, long long ldw, int k, float* B,
                   int masked, uint64_t seed, long long cell_offset,
                   int inv_density, const uint32_t* words, long long wld,
                   void* stream) {
  if (cells <= 0 || k <= 0) return cudaSuccess;
  const long long blocks = (cells + kWideWarps - 1) / kWideWarps;
  const long long chunks = (k + 32 * kWideNpl - 1) / (32 * kWideNpl);
  if (inv_density < 1 || masked < 0 || masked > 2 ||
      (masked == 2 && words == nullptr) || n_gb < 0 || width < 0 ||
      gene_block < 1 || ldw < k || blocks > 0x7fffffffLL || chunks > 65535) {
    return cudaErrorInvalidValue;
  }
  const OddDivisor d = odd_divisor((uint64_t)inv_density);
  const B3WideArgs a{li, lv, ld, n_gb, width, cells, gene_block, W, ldw, k,
                     B, seed, cell_offset, d.shift, d.inverse, d.limit,
                     words, wld};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 grid((unsigned)blocks, (unsigned)chunks);
  switch (masked) {
    case 0:
      bell_spmm_wide_kernel<0><<<grid, kWideWarps * 32, 0, s>>>(a);
      break;
    case 1:
      bell_spmm_wide_kernel<1><<<grid, kWideWarps * 32, 0, s>>>(a);
      break;
    default:
      bell_spmm_wide_kernel<2><<<grid, kWideWarps * 32, 0, s>>>(a);
  }
  return cudaGetLastError();
}

const char* bell_spmm_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"

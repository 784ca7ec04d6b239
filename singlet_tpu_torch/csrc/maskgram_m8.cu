// The prebuilt int8 test mask of the ELL engine's SINGLET_TPU_MASK8=1 route:
// kernel B12, which expands bitplane words into a dense int8 0/1 mask, for
// sm_90a. (B13 and B14, the products reading that mask, share one GEMM with
// B8-B11 in csrc/maskgram_gemm.cu, each after a pass that packs the mask
// along the product's K axis.)
//
// B12 (`unpack_mask_bits`) replaces singlet_tpu/ops/maskbits.py
// `unpack_mask_bits` (kernel body `_unpack8_kernel`):
//
//   B12:  mask8[c, gb * GB + w] = (words[c, (gb >> 5) * GB + w] >> (gb & 31)) & 1
//
// What bounds it. B12 reads 4 bytes per word and writes one byte per
// (cell, gene): at 32,768 cells (a group of 16 blocks of 2048) x 16,384
// genes 64 MiB in and 512 MiB out, 0.19 ms at 3.35 TB/s: bytes.
//
// Design. One thread per word writes the word's 32 bitplanes as bytes; the
// threads of a warp take neighbouring words of a row, so each of the 32
// stores of a warp covers 32 neighbouring bytes.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

// B12. One thread per word idx = (cell c, word column col = t GB + w).
__global__ void __launch_bounds__(256)
unpack8_kernel(const uint32_t* __restrict__ words, int cells, int wcols,
               int gene_block, int n_gb, int8_t* __restrict__ out) {
  const long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= (long long)cells * wcols) return;
  const long long c = idx / wcols;
  const int col = (int)(idx - c * wcols);
  const int t = col / gene_block, w = col - t * gene_block;
  const uint32_t word = words[idx];
  int8_t* o = out + c * ((long long)n_gb * gene_block) + w;
  const int s_end = min(32, n_gb - t * 32);
  for (int s = 0; s < s_end; ++s) {
    o[(long long)(t * 32 + s) * gene_block] = (int8_t)((word >> s) & 1u);
  }
}

}  // namespace

extern "C" {

// Device pointers, all contiguous: words (cells, wcols) uint32 with wcols =
// n_t * gene_block, n_t = ceil(n_gb / 32); out (cells, n_gb * gene_block)
// int8. Returns the cudaError_t of the launch (0 on success).
int unpack_mask_bits(const uint32_t* words, int cells, int wcols,
                     int gene_block, int n_gb, int8_t* out, void* stream) {
  if (cells <= 0 || n_gb <= 0) return cudaSuccess;
  if (gene_block <= 0 || wcols != ((n_gb + 31) / 32) * gene_block) {
    return cudaErrorInvalidValue;
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long long n = (long long)cells * wcols;
  unpack8_kernel<<<(unsigned)((n + 255) / 256), 256, 0, s>>>(
      words, cells, wcols, gene_block, n_gb, out);
  return cudaGetLastError();
}

const char* maskgram_m8_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"

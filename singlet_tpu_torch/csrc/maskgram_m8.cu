// The prebuilt int8 test mask of the ELL engine's SINGLET_TPU_MASK8=1 route:
// kernel B12, which expands bitplane words into a dense int8 0/1 mask, and
// kernel B13, the w-side masked packed-Gram product reading that mask, for
// sm_90a. (B14, the carry product reading it, shares one GEMM with B9-B11
// in csrc/maskgram_gemm.cu.)
//
// B12 (`unpack_mask_bits`) replaces singlet_tpu/ops/maskbits.py
// `unpack_mask_bits` (kernel body `_unpack8_kernel`) and B13
// (`mask_packed_w_t_m8`) replaces singlet_tpu/ops/pallas_maskgram.py
// `mask_packed_w_t_m8` (`_mpw_m8_kernel`):
//
//   B12:  mask8[c, gb * GB + w] = (words[c, (gb >> 5) * GB + w] >> (gb & 31)) & 1
//   B13:  out[p, c] = sum_g mask8[c, g] P[g, p]        P (genes_pad, np)
//
// B13 is B8 of maskgram_bits.cu with the mask read as bytes instead of
// bits: P is int8 (per-pair scales from quantize_pairs: exact int32 sums,
// then one multiply per pair) or bf16 (float32 sums). So on int8 B13 gives
// the bits of B8 on the same mask. B13's K chunks are 32 consecutive genes
// where B8's are the 32 bitplanes of one word column, so bf16 B13 sums in
// another order than bf16 B8.
//
// What bounds them. B12 reads 4 bytes per word and writes one byte per
// (cell, gene): at 32,768 cells (a group of 16 blocks of 2048) x 16,384 genes
// 64 MiB in and 512 MiB out, 0.19 ms at 3.35 TB/s: bytes. B13 does the
// dense product of B8 (339 GOP per 2048-cell block at k = 100, 5050 pairs),
// 0.17 ms at the 1,979 TOP/s int8 peak, and reads the mask as bytes: 32 MiB
// per block where B8 reads 4 MiB of words. The dense product bounds it; the
// mask is 5% dense, so a sparse formulation needs fewer operations, work
// for a later change.
//
// Design. B12: one thread per word writes the word's 32 bitplanes as bytes;
// the threads of a warp take neighbouring words of a row, so each of the 32
// stores of a warp covers 32 neighbouring bytes. B13: the tile and mma of B8
// (128 cells x 128 pairs, 8 warps of 16 cells, K chunks of 32), with the
// chunk's (128 cells x 32 genes) mask tile staged in shared memory by 16-byte
// loads of its rows, the cells' natural layout, from which each A fragment
// register is one 4-byte read (int8) or two 2-byte reads turned into bf16
// (bf16). P is staged transposed in shared memory as B8 stages it, the next
// chunk loaded into registers while the current one multiplies. Each block
// owns its output tile: no atomics.
//
// Right and simple first: no TMA, no wgmma, one stage of register prefetch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kChunk = 32;                // K per chunk
constexpr int kB13Cells = kWarps * 16;    // B13 tile: 128 cells
constexpr int kB13Pairs = 128;            //           x 128 pairs
// shared pitch, in bytes, of B13's (cells x 32 genes) mask tile (16-byte
// aligned rows for the staging stores)
constexpr int kMaskPitch13 = 48;

// shared-memory pitch of a staged P row (K-contiguous), in elements
template <typename T>
constexpr int kPitch = sizeof(T) == 1 ? 36 : 34;

template <typename T>
using AccT = std::conditional_t<sizeof(T) == 1, int, float>;

__device__ __forceinline__ void mma(int (&d)[4], const uint32_t (&a)[4],
                                    const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4],
                                    const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__device__ __forceinline__ uint32_t ld32(const uint8_t* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// two int8 mask bytes at p (p[0] the lower K index) as two bf16 lanes, exact
__device__ __forceinline__ uint32_t bf16x2(const uint8_t* p) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(
      static_cast<float>(static_cast<int8_t>(p[0])),
      static_cast<float>(static_cast<int8_t>(p[1])));
  return *reinterpret_cast<const uint32_t*>(&v);
}

// acc[j] += A (16 rows x 32 K: rows r0 and r0 + 8 rows of sA, K-contiguous
// bytes) times B (32 K x 8 columns j * 8 .. j * 8 + 7, staged K-contiguous per
// column in sB), for the NT column tiles of one warp; r0 and r1 point at the
// rows g and g + 8 of the warp's 16
template <typename T, int NT>
__device__ __forceinline__ void mma_chunk(AccT<T> (&acc)[NT][4],
                                          const uint8_t* r0, const uint8_t* r1,
                                          const T* sB, int g, int t) {
  constexpr int P = kPitch<T>;
  if constexpr (sizeof(T) == 1) {
    const uint32_t a[4] = {ld32(r0 + t * 4), ld32(r1 + t * 4),
                           ld32(r0 + 16 + t * 4), ld32(r1 + 16 + t * 4)};
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      const T* col = sB + (j * 8 + g) * P;
      const uint32_t b[2] = {
          *reinterpret_cast<const uint32_t*>(col + t * 4),
          *reinterpret_cast<const uint32_t*>(col + 16 + t * 4)};
      mma(acc[j], a, b);
    }
  } else {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int k0 = h * 16 + t * 2;
      const uint32_t a[4] = {bf16x2(r0 + k0), bf16x2(r1 + k0),
                             bf16x2(r0 + k0 + 8), bf16x2(r1 + k0 + 8)};
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        const T* col = sB + (j * 8 + g) * P;
        const uint32_t b[2] = {
            *reinterpret_cast<const uint32_t*>(col + k0),
            *reinterpret_cast<const uint32_t*>(col + k0 + 8)};
        mma(acc[j], a, b);
      }
    }
  }
}

// 16 mask bytes of `row` from column `col0`, zero past `end` columns; one
// 16-byte load where `vec` (row and columns 16-byte aligned)
__device__ __forceinline__ uint4 load16(const int8_t* __restrict__ row,
                                        long long col0, long long end,
                                        bool vec) {
  if (vec && col0 + 16 <= end) {
    return *reinterpret_cast<const uint4*>(row + col0);
  }
  uint32_t w[4] = {0u, 0u, 0u, 0u};
#pragma unroll
  for (int b = 0; b < 16; ++b) {
    if (col0 + b < end) {
      w[b >> 2] |= (uint32_t)(uint8_t)row[col0 + b] << ((b & 3) * 8);
    }
  }
  return make_uint4(w[0], w[1], w[2], w[3]);
}

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

// B13. Grid (ceil(block / 128), ceil(np / 128)); warp v owns cells
// blockIdx.x * 128 + 16 v .. + 15 and all 128 pairs of the tile.
template <typename T>
__global__ void __launch_bounds__(kThreads)
mpw_m8_kernel(const T* __restrict__ P, int np,
              const float* __restrict__ scales,
              const int8_t* __restrict__ mask, int block, int genes_pad,
              bool vec, float* __restrict__ out) {
  constexpr int NT = kB13Pairs / 8;
  constexpr int kStage = kB13Pairs * kChunk / kThreads;   // 16 per thread
  __shared__ __align__(16) T sB[kB13Pairs * kPitch<T>];
  __shared__ __align__(16) uint8_t sA[kB13Cells * kMaskPitch13];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const long long cell_base = (long long)blockIdx.x * kB13Cells;
  const long long cell0 = cell_base + warp * 16 + g;
  const long long cell1 = cell0 + 8;
  const int p0 = blockIdx.y * kB13Pairs;
  // staging of P: gene ss of the chunk, pairs sq .. sq + 15 of the tile
  const int ss = threadIdx.x >> 3, sq = (threadIdx.x & 7) * kStage;
  // staging of the mask: cell mc of the tile, genes mh .. mh + 15 of the chunk
  const int mc = threadIdx.x >> 1, mh = (threadIdx.x & 1) * 16;
  const long long mcell = cell_base + mc;
  const int8_t* mrow = mask + mcell * genes_pad;
  const int n_chunks = (genes_pad + kChunk - 1) / kChunk;

  AccT<T> acc[NT][4];
#pragma unroll
  for (int j = 0; j < NT; ++j)
#pragma unroll
    for (int i = 0; i < 4; ++i) acc[j][i] = 0;

  T v[kStage];
  uint4 mv;
  auto load = [&](int kc) {
    const long long gene = (long long)kc * kChunk + ss;
    const T* row = P + gene * np + p0 + sq;
#pragma unroll
    for (int e = 0; e < kStage; ++e) {
      v[e] = (gene < genes_pad && p0 + sq + e < np) ? row[e] : T(0);
    }
    mv = mcell < block ? load16(mrow, (long long)kc * kChunk + mh, genes_pad,
                                vec)
                       : make_uint4(0u, 0u, 0u, 0u);
  };

  load(0);
  for (int kc = 0; kc < n_chunks; ++kc) {
    __syncthreads();  // the previous chunk's tiles are consumed
#pragma unroll
    for (int e = 0; e < kStage; ++e) sB[(sq + e) * kPitch<T> + ss] = v[e];
    *reinterpret_cast<uint4*>(sA + mc * kMaskPitch13 + mh) = mv;
    __syncthreads();
    if (kc + 1 < n_chunks) load(kc + 1);
    const uint8_t* r0 = sA + (warp * 16 + g) * kMaskPitch13;
    mma_chunk<T, NT>(acc, r0, r0 + 8 * kMaskPitch13, sB, g, t);
  }

#pragma unroll
  for (int j = 0; j < NT; ++j) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const long long c = i < 2 ? cell0 : cell1;
      const int p = p0 + j * 8 + t * 2 + (i & 1);
      if (c < block && p < np) {
        float val;
        if constexpr (sizeof(T) == 1) {
          val = __fmul_rn(__int2float_rn(acc[j][i]), scales[p]);
        } else {
          val = acc[j][i];
        }
        out[(long long)p * block + c] = val;
      }
    }
  }
}

bool aligned16(const void* p, int genes_pad) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0 && genes_pad % 16 == 0;
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

// P (genes_pad, np) int8 (int8 != 0) or bf16 bit patterns, scales (np,)
// float32 (int8 only), mask (block, genes_pad) int8 0/1, out (np, block)
// float32.
int mask_packed_w_t_m8(const void* P, int int8, int np, const float* scales,
                       const int8_t* mask, int block, int genes_pad,
                       float* out, void* stream) {
  if (block <= 0 || np <= 0) return cudaSuccess;
  if (genes_pad <= 0) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool vec = aligned16(mask, genes_pad);
  const dim3 grid((block + kB13Cells - 1) / kB13Cells,
                  (np + kB13Pairs - 1) / kB13Pairs);
  if (int8) {
    mpw_m8_kernel<uint8_t><<<grid, kThreads, 0, s>>>(
        static_cast<const uint8_t*>(P), np, scales, mask, block, genes_pad,
        vec, out);
  } else {
    mpw_m8_kernel<uint16_t><<<grid, kThreads, 0, s>>>(
        static_cast<const uint16_t*>(P), np, scales, mask, block, genes_pad,
        vec, out);
  }
  return cudaGetLastError();
}

const char* maskgram_m8_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"

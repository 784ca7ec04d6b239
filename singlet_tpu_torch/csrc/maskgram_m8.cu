// The prebuilt int8 test mask of the ELL engine's SINGLET_TPU_MASK8=1 route:
// kernel B12, which expands bitplane words into a dense int8 0/1 mask, and
// kernels B13 and B14, the masked packed-Gram products reading that mask,
// for sm_90a.
//
// B12 (`unpack_mask_bits`) replaces singlet_tpu/ops/maskbits.py
// `unpack_mask_bits` (kernel body `_unpack8_kernel`), B13
// (`mask_packed_w_t_m8`) replaces singlet_tpu/ops/pallas_maskgram.py
// `mask_packed_w_t_m8` (`_mpw_m8_kernel`) and B14 (`mask_packed_h_t_m8`)
// replaces `mask_packed_h_t_m8` (`_mph_m8_kernel`):
//
//   B12:  mask8[c, gb * GB + w] = (words[c, (gb >> 5) * GB + w] >> (gb & 31)) & 1
//   B13:  out[p, c]  = sum_g mask8[c, g] P[g, p]       P (genes_pad, np)
//   B14:  acc[p, g] += sum_c mask8[c, g] P[c, p]       P (cells, np)
//
// B13 and B14 are B8 and B9 of maskgram_bits.cu with the mask read as bytes
// instead of bits: P is int8 (per-pair scales from quantize_pairs: exact
// int32 sums, then one multiply per pair) or bf16 (float32 sums). B14 forms
// one partial per cell sub-block of `bc` cells (int8: times the scale column
// of its quantization group) and adds it into the carry in sub-block order,
// `(acc + d0) + d1 + ...`, with __fmul_rn/__fadd_rn as B9 does. So on int8
// B13 and B14 give the bits of B8 and B9 on the same mask. On bf16 B14 also
// gives B9's bits: its K order within a chunk (the chunk's 32 cells in
// order) and its fragments are B9's. B13's K chunks are 32 consecutive genes
// where B8's are the 32 bitplanes of one word column, so bf16 B13 sums in
// another order than bf16 B8.
//
// What bounds them. B12 reads 4 bytes per word and writes one byte per
// (cell, gene): at 32,768 cells (a group of 16 blocks of 2048) x 16,384 genes
// 64 MiB in and 512 MiB out, 0.19 ms at 3.35 TB/s: bytes. B13 and B14 do the
// dense products of B8 and B9 (339 GOP per 2048-cell block at k = 100, 5050
// pairs; 5.4 TOP per group), 0.17 ms and 2.7 ms at the 1,979 TOP/s int8 peak,
// and read the mask as bytes: 32 MiB per block, 512 MiB per group, where B8
// and B9 read 4 MiB and 64 MiB of words. The dense products bound them; the
// mask is 5% dense, so a sparse formulation needs fewer operations, work for
// a later change.
//
// Design. B12: one thread per word writes the word's 32 bitplanes as bytes;
// the threads of a warp take neighbouring words of a row, so each of the 32
// stores of a warp covers 32 neighbouring bytes. B13: the tile and mma of B8
// (128 cells x 128 pairs, 8 warps of 16 cells, K chunks of 32), with the
// chunk's (128 cells x 32 genes) mask tile staged in shared memory by 16-byte
// loads of its rows, the cells' natural layout, from which each A fragment
// register is one 4-byte read (int8) or two 2-byte reads turned into bf16
// (bf16). B14: the tile and sub-block walk of B9 (128 genes x 64 pairs, 8
// warps of 16 genes, K = 32 cells per chunk); K is the mask's row axis, so
// the chunk's (32 cells x 128 genes) mask tile is loaded by 16-byte row
// reads and stored TRANSPOSED in shared memory, genes x cells, where the A
// fragments read it as B13 does. P is staged transposed in shared memory as
// B8/B9 stage it, the next chunk loaded into registers while the current
// one multiplies. Each block owns its output tile: no atomics.
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
constexpr int kB14Genes = kWarps * 16;    // B14 tile: 128 genes
constexpr int kB14Pairs = 64;             //           x 64 pairs
// shared pitch, in bytes, of B13's (cells x 32 genes) mask tile (16-byte
// aligned rows for the staging stores) and of B14's transposed (genes x 32
// cells) tile
constexpr int kMaskPitch13 = 48;
constexpr int kMaskPitch14 = 36;

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

// B14. Grid (ceil(genes_pad / 128), ceil(np / 64)); warp v owns genes
// blockIdx.x * 128 + 16 v .. + 15 and all 64 pairs of the tile.
template <typename T>
__global__ void __launch_bounds__(kThreads)
mph_m8_kernel(const T* __restrict__ P, int np,
              const float* __restrict__ scales, int n_scales,
              const int8_t* __restrict__ mask, int cells, int genes_pad,
              bool vec, int bc, int scale_block, float* __restrict__ acc) {
  constexpr int NT = kB14Pairs / 8;
  constexpr int kStage = kB14Pairs * kChunk / kThreads;   // 8 per thread
  __shared__ __align__(16) T sB[kB14Pairs * kPitch<T>];
  __shared__ __align__(16) uint8_t sA[kB14Genes * kMaskPitch14];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const long long gene_base = (long long)blockIdx.x * kB14Genes;
  const long long gene0 = gene_base + warp * 16 + g, gene1 = gene0 + 8;
  const bool ok0 = gene0 < genes_pad, ok1 = gene1 < genes_pad;
  const int p0 = blockIdx.y * kB14Pairs;
  // staging of P: cell sj of the chunk, pairs sq .. sq + 7 of the tile
  const int sj = threadIdx.x >> 3, sq = (threadIdx.x & 7) * kStage;
  // staging of the mask: cell sj of the chunk, genes mg .. mg + 15 of the tile
  const int mg = (threadIdx.x & 7) * 16;

  float run[NT][4];
  AccT<T> part[NT][4];
#pragma unroll
  for (int j = 0; j < NT; ++j) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int p = p0 + j * 8 + t * 2 + (i & 1);
      const bool ok = (i < 2 ? ok0 : ok1) && p < np;
      run[j][i] = ok ? acc[(long long)p * genes_pad + (i < 2 ? gene0 : gene1)]
                     : 0.f;
      part[j][i] = 0;
    }
  }

  const int per_sub = (bc + kChunk - 1) / kChunk;        // chunks per sub-block
  const int n_q = (cells / bc) * per_sub;
  T v[kStage];
  uint4 mv;
  auto load = [&](int q) {
    const int sb = q / per_sub;
    const long long c0 = (long long)sb * bc + (long long)(q % per_sub) * kChunk;
    const long long end = (long long)sb * bc + bc;
    const long long c = c0 + sj;
    const T* row = P + c * np + p0 + sq;
#pragma unroll
    for (int e = 0; e < kStage; ++e) {
      v[e] = (c < end && p0 + sq + e < np) ? row[e] : T(0);
    }
    mv = c < end ? load16(mask + c * genes_pad, gene_base + mg, genes_pad, vec)
                 : make_uint4(0u, 0u, 0u, 0u);
  };

  load(0);
  for (int q = 0; q < n_q; ++q) {
    __syncthreads();
#pragma unroll
    for (int e = 0; e < kStage; ++e) sB[(sq + e) * kPitch<T> + sj] = v[e];
    const uint32_t mw[4] = {mv.x, mv.y, mv.z, mv.w};
#pragma unroll
    for (int b = 0; b < 16; ++b) {
      sA[(mg + b) * kMaskPitch14 + sj] =
          (uint8_t)(mw[b >> 2] >> ((b & 3) * 8));
    }
    __syncthreads();
    if (q + 1 < n_q) load(q + 1);
    const uint8_t* r0 = sA + (warp * 16 + g) * kMaskPitch14;
    mma_chunk<T, NT>(part, r0, r0 + 8 * kMaskPitch14, sB, g, t);
    if (q % per_sub == per_sub - 1) {
      // the sub-block is complete: dequantize and add, in sub-block order
      const int col = (int)(((long long)(q / per_sub) * bc) / scale_block);
#pragma unroll
      for (int j = 0; j < NT; ++j) {
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          if constexpr (sizeof(T) == 1) {
            const int p = p0 + j * 8 + t * 2 + (i & 1);
            const float sc = p < np ? scales[(long long)p * n_scales + col]
                                    : 0.f;
            run[j][i] = __fadd_rn(run[j][i],
                                  __fmul_rn(__int2float_rn(part[j][i]), sc));
          } else {
            run[j][i] = __fadd_rn(run[j][i], part[j][i]);
          }
          part[j][i] = 0;
        }
      }
    }
  }

#pragma unroll
  for (int j = 0; j < NT; ++j) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int p = p0 + j * 8 + t * 2 + (i & 1);
      if ((i < 2 ? ok0 : ok1) && p < np) {
        acc[(long long)p * genes_pad + (i < 2 ? gene0 : gene1)] = run[j][i];
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

// P (cells, np) int8 or bf16, scales (np, n_scales) float32 (int8 only),
// mask (cells, genes_pad) int8 0/1, acc (np, genes_pad) float32 updated in
// place; `bc` divides `scale_block`, which divides `cells`.
int mask_packed_h_t_m8(const void* P, int int8, int np, const float* scales,
                       int n_scales, const int8_t* mask, int cells,
                       int genes_pad, int bc, int scale_block, float* acc,
                       void* stream) {
  if (cells <= 0 || np <= 0 || genes_pad <= 0) return cudaSuccess;
  if (bc <= 0 || scale_block % bc != 0 || cells % scale_block != 0) {
    return cudaErrorInvalidValue;
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool vec = aligned16(mask, genes_pad);
  const dim3 grid((genes_pad + kB14Genes - 1) / kB14Genes,
                  (np + kB14Pairs - 1) / kB14Pairs);
  if (int8) {
    mph_m8_kernel<uint8_t><<<grid, kThreads, 0, s>>>(
        static_cast<const uint8_t*>(P), np, scales, n_scales, mask, cells,
        genes_pad, vec, bc, scale_block, acc);
  } else {
    mph_m8_kernel<uint16_t><<<grid, kThreads, 0, s>>>(
        static_cast<const uint16_t*>(P), np, scales, n_scales, mask, cells,
        genes_pad, vec, bc, scale_block, acc);
  }
  return cudaGetLastError();
}

const char* maskgram_m8_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"

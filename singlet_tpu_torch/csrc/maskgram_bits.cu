// Masked packed-Gram product of the bits route: kernel B8 of the port, with
// the test mask read from bitplane words, for sm_90a. (B9, the bits route's
// carry product, shares one GEMM with B10, B11 and B14 in
// csrc/maskgram_gemm.cu.)
//
// B8 (`mask_packed_w_t_bits`) replaces singlet_tpu/ops/pallas_maskgram.py
// `mask_packed_w_t_bits` (kernel body `_mpw_bits_kernel`):
//
//   B8:  out[p, c] = sum_g mask(c, g) P[g, p]          P (genes_pad, np)
//
// with mask(c, gb * GB + w) = (words[c, (gb >> 5) * GB + w] >> (gb & 31)) & 1
// (singlet_tpu_torch/ops/maskbits.py). P is int8 (per-pair scales from
// quantize_pairs: exact int32 sums, then one multiply per pair, __fmul_rn,
// so the int8 path gives the bits of the plain version) or bf16 (float32
// sums).
//
// What bounds it. At 524,288 cells x 16,384 genes, k = 100 (5050 pairs),
// the dense product is 339 GOP per 2048-cell block: 0.17 ms at the 1,979
// TOP/s int8 peak (twice that at the 989 TFLOP/s bf16 peak). It reads
// little (P 83 MB int8, 165 MB bf16; the words 4 MB per block), so the
// dense product is bound by the tensor cores. The mask is 5% dense, so a
// sparse formulation needs fewer operations; that is work for a later
// change.
//
// Design. It runs on the tensor cores through `mma.sync` (m16n8k32 s8 x s8
// -> s32, or m16n8k16 bf16 x bf16 -> f32), with the mask as the A operand
// built in registers straight from the bits, never stored. The TPU unpacks
// a (gene block x cells) tile per grid step. Here the K axis is walked so
// that one loaded word gives all its bits: a K chunk of 32 is one word
// column (local gene w of word group t) and its 32 bits are the genes
// (32 t + s) GB + w, s = 0..31; the A fragment of a cell row is a few shifts
// of that one word. The chunk's 32 rows of P (one row per bitplane) are
// staged transposed in shared memory as the B operand. Each block owns its
// output tile, so there are no atomics. The next chunk's P and words are
// loaded into registers while the current chunk multiplies.
//
// Right and simple first: no TMA, no wgmma, one stage of register
// prefetch.

#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kChunk = 32;                // K per chunk
constexpr int kB8Cells = kWarps * 16;     // B8 tile: 128 cells
constexpr int kB8Pairs = 128;             //          x 128 pairs

// shared-memory pitch of a staged row (K-contiguous), in elements: a
// multiple of 4 bytes, padded against bank conflicts
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

// the low 4 bits of x as four 0/1 int8 lanes (bit i -> byte i)
__device__ __forceinline__ uint32_t bytes4(uint32_t x) {
  return (x & 1u) | ((x & 2u) << 7) | ((x & 4u) << 14) | ((x & 8u) << 21);
}

// the low 2 bits of x as two bf16 lanes of 0.0 / 1.0 (bit i -> half i)
__device__ __forceinline__ uint32_t bf16x2(uint32_t x) {
  return ((x & 1u) * 0x3F80u) | (((x >> 1) & 1u) * 0x3F800000u);
}

// acc[j] += A (16 rows x 32 K: row g's K bits in bits0, row g + 8's in
// bits1) times B (32 K x 8 columns j * 8 .. j * 8 + 7, staged K-contiguous
// per column in sB), for the NT column tiles of one warp
template <typename T, int NT>
__device__ __forceinline__ void mma_chunk(AccT<T> (&acc)[NT][4],
                                          uint32_t bits0, uint32_t bits1,
                                          const T* sB, int g, int t) {
  constexpr int P = kPitch<T>;
  if constexpr (sizeof(T) == 1) {
    const uint32_t a[4] = {bytes4(bits0 >> (t * 4)), bytes4(bits1 >> (t * 4)),
                           bytes4(bits0 >> (16 + t * 4)),
                           bytes4(bits1 >> (16 + t * 4))};
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
      const uint32_t a[4] = {bf16x2(bits0 >> k0), bf16x2(bits1 >> k0),
                             bf16x2(bits0 >> (k0 + 8)),
                             bf16x2(bits1 >> (k0 + 8))};
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

// B8. Grid (ceil(block / 128), ceil(np / 128)); warp v owns cells
// blockIdx.x * 128 + 16 v .. + 15 and all 128 pairs of the tile.
template <typename T>
__global__ void __launch_bounds__(kThreads)
mpw_bits_kernel(const T* __restrict__ P, int np,
                const float* __restrict__ scales,
                const uint32_t* __restrict__ words, int block, int wcols,
                int gene_block, int n_gb, float* __restrict__ out) {
  constexpr int NT = kB8Pairs / 8;
  constexpr int kStage = kB8Pairs * kChunk / kThreads;   // 16 per thread
  __shared__ __align__(16) T sB[kB8Pairs * kPitch<T>];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const long long cell0 = (long long)blockIdx.x * kB8Cells + warp * 16 + g;
  const long long cell1 = cell0 + 8;
  const int p0 = blockIdx.y * kB8Pairs;
  // staging: bitplane ss of the chunk, pairs sq .. sq + 15 of the tile
  const int ss = threadIdx.x >> 3, sq = (threadIdx.x & 7) * kStage;

  AccT<T> acc[NT][4];
#pragma unroll
  for (int j = 0; j < NT; ++j)
#pragma unroll
    for (int i = 0; i < 4; ++i) acc[j][i] = 0;

  T v[kStage];
  uint32_t nb0 = 0, nb1 = 0;
  auto load = [&](int kc) {
    const int tg = kc / gene_block, w = kc - tg * gene_block;
    const int gb = tg * 32 + ss;
    const T* row = P + ((long long)gb * gene_block + w) * np + p0 + sq;
#pragma unroll
    for (int e = 0; e < kStage; ++e) {
      v[e] = (gb < n_gb && p0 + sq + e < np) ? row[e] : T(0);
    }
    nb0 = cell0 < block ? words[cell0 * wcols + kc] : 0u;
    nb1 = cell1 < block ? words[cell1 * wcols + kc] : 0u;
  };

  load(0);
  for (int kc = 0; kc < wcols; ++kc) {
    __syncthreads();  // the previous chunk's tile is consumed
#pragma unroll
    for (int e = 0; e < kStage; ++e) sB[(sq + e) * kPitch<T> + ss] = v[e];
    __syncthreads();
    const uint32_t bits0 = nb0, bits1 = nb1;
    if (kc + 1 < wcols) load(kc + 1);
    mma_chunk<T, NT>(acc, bits0, bits1, sB, g, t);
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

}  // namespace

extern "C" {

// Device pointers, all contiguous: P (genes_pad, np) int8 (int8 != 0) or
// bf16 bit patterns, scales (np,) float32 (int8 only), words (block, wcols)
// uint32 with wcols = n_t * gene_block, out (np, block) float32. Returns the
// cudaError_t of the launch (0 on success).
int mask_packed_w_t_bits(const void* P, int int8, int np, const float* scales,
                         const uint32_t* words, int block, int wcols,
                         int gene_block, int n_gb, float* out, void* stream) {
  if (block <= 0 || np <= 0) return cudaSuccess;
  if (gene_block <= 0 || wcols % gene_block != 0) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 grid((block + kB8Cells - 1) / kB8Cells,
                  (np + kB8Pairs - 1) / kB8Pairs);
  if (int8) {
    mpw_bits_kernel<uint8_t><<<grid, kThreads, 0, s>>>(
        static_cast<const uint8_t*>(P), np, scales, words, block, wcols,
        gene_block, n_gb, out);
  } else {
    mpw_bits_kernel<uint16_t><<<grid, kThreads, 0, s>>>(
        static_cast<const uint16_t*>(P), np, scales, words, block, wcols,
        gene_block, n_gb, out);
  }
  return cudaGetLastError();
}

const char* maskgram_bits_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"

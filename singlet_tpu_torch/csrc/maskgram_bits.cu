// Masked packed-Gram products: kernels B8 and B9 of the port, with the test
// mask read from bitplane words, and B10 and B11, with the mask hashed from
// (seed, cell, gene), for sm_90a.
//
// B8 (`mask_packed_w_t_bits`) replaces singlet_tpu/ops/pallas_maskgram.py
// `mask_packed_w_t_bits` (kernel body `_mpw_bits_kernel`), B9
// (`mask_packed_h_t_bits`) replaces `mask_packed_h_t_bits` (`_mph_bits_body`),
// B10 (`mask_packed_w_t_hash`) replaces `mask_packed_w_t` (`_mpw_kernel`) and
// B11 (`mask_packed_h_t_hash`) replaces `mask_packed_h_t` (`_mph_kernel`):
//
//   B8, B10:  out[p, c]  = sum_g mask(c, g) P[g, p]          P (genes_pad, np)
//   B9, B11:  acc[p, g] += sum_c mask(c, g) P[c, p]          P (cells, np)
//
// with mask(c, gb * GB + w) = (words[c, (gb >> 5) * GB + w] >> (gb & 31)) & 1
// (singlet_tpu_torch/ops/maskbits.py). P is int8 (per-pair scales from
// quantize_pairs: exact int32 sums, then one multiply per pair) or bf16
// (float32 sums); B10 and B11 take bf16 only. B9 and B11 form one partial
// per cell sub-block of `bc` cells (int8: multiplied by the scale column of
// its quantization group) and add it into the carry in sub-block order,
// `(acc + d0) + d1 + ...`, as the JAX kernels do; __fmul_rn and __fadd_rn
// keep nvcc from contracting that into an FMA, so the int8 path gives the
// bits of the plain version.
//
// B10 and B11: the hash. The TPU kernels hash the (cells x gene block) mask
// tile of each grid step in VMEM. A tile of cells here meets every pair
// tile, so hashing inside the product tile would hash each (cell, gene) once
// per pair tile (79 tiles of 64 pairs at k = 100). Instead each call runs
// two kernels: `hash_words_kernel` hashes every (cell, gene) of the call
// exactly once into bitplane words of the maskbits layout, in a scratch
// buffer the wrapper allocates (4 MiB per 2048-cell block at 16,384 genes,
// well inside the L2), and the product kernel of B8 or B9 reads them. The
// hash is singlet_tpu_torch/ops/rngmask.py `mask_block` bit for bit (the
// same code as bell_spmm.cu's, with x % inv_density taken from the two
// 32-bit halves as rngmask.u64_mod_small takes it), with the validity
// clamps: cell ids at or past cells_true and genes at or past genes_true
// are never held out. The words are those `pack_mask_words` packs for the
// same cells, so B10 gives the bits of bf16 B8 on them, and B11 those of
// bf16 B9 with one quantization group.
//
// What bounds them. At 524,288 cells x 16,384 genes, k = 100 (5050 pairs),
// the dense products are 339 GOP per 2048-cell block (B8, B10) and 5.4 TOP
// per group of 16 blocks (B9): 0.17 ms and 2.7 ms at the 1,979 TOP/s int8
// peak (twice that at the 989 TFLOP/s bf16 peak). They read little (P 83 MB
// int8, 165 MB bf16; the words 4 MB per block; B9 and B11 also read and
// write the 331 MB carry once per call), so the dense products are bound by
// the tensor cores. The mask is 5% dense, so a sparse formulation needs
// fewer operations; that is work for a later change. The hash pass is 34M
// hashes per block, some 0.1-0.3 ms of integer work.
//
// Design of the products. Both run on the tensor cores through `mma.sync`
// (m16n8k32 s8 x s8 -> s32, or m16n8k16 bf16 x bf16 -> f32), with the mask
// as the A operand built in registers straight from the bits, never stored:
//
// * The TPU unpacks a (gene block x cells) tile per grid step. Here the K
//   axis is walked so that one loaded word gives all its bits: in B8 a K
//   chunk of 32 is one word column (local gene w of word group t) and its
//   32 bits are the genes (32 t + s) GB + w, s = 0..31; the A fragment of a
//   cell row is a few shifts of that one word. The chunk's 32 rows of P
//   (one row per bitplane) are staged transposed in shared memory as the B
//   operand.
// * In B9 the rows of the product are genes and K is cells. A block owns
//   4 local genes x 32 bitplanes of one word group (128 genes) and 64 pairs;
//   per chunk of 32 cells each lane loads one cell's word of its warp's
//   local gene and 16 warp ballots turn the 32 words into the 32-cell bit
//   rows of the warp's 16 genes. P's 32 rows are staged transposed.
// * Each block owns its output tile, so there are no atomics; B9 updates
//   the carry in place (read once, written once). The next chunk's P and
//   words are loaded into registers while the current chunk multiplies.
//
// Right and simple first: no TMA, no wgmma, one stage of register
// prefetch.

#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kChunk = 32;                // K per chunk
constexpr int kB8Cells = kWarps * 16;     // B8 tile: 128 cells
constexpr int kB8Pairs = 128;             //          x 128 pairs
constexpr int kB9Locals = 4;              // B9 tile: 4 local genes x 32
constexpr int kB9Pairs = 64;              //          bitplanes x 64 pairs

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

// B9. Grid (n_t * ceil(gene_block / 4), ceil(np / 64)); block x owns word
// group x / w_tiles and local genes 4 (x % w_tiles) .. + 3; warp v owns
// local gene (v >> 1) at bitplanes 16 (v & 1) .. + 15, its 16 rows.
template <typename T>
__global__ void __launch_bounds__(kThreads)
mph_bits_kernel(const T* __restrict__ P, int np,
                const float* __restrict__ scales, int n_scales,
                const uint32_t* __restrict__ words, int cells, int wcols,
                int gene_block, int n_gb, int genes_pad, int bc,
                int scale_block, float* __restrict__ acc) {
  constexpr int NT = kB9Pairs / 8;
  constexpr int kStage = kB9Pairs * kChunk / kThreads;   // 8 per thread
  __shared__ __align__(16) T sB[kB9Pairs * kPitch<T>];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int w_tiles = (gene_block + kB9Locals - 1) / kB9Locals;
  const int tg = blockIdx.x / w_tiles;
  const int w = (blockIdx.x % w_tiles) * kB9Locals + (warp >> 1);
  const int s_base = (warp & 1) * 16;
  const bool w_ok = w < gene_block;
  const int gb0 = tg * 32 + s_base + g, gb1 = gb0 + 8;
  const long long gene0 = (long long)gb0 * gene_block + w;
  const long long gene1 = (long long)gb1 * gene_block + w;
  const bool ok0 = w_ok && gb0 < n_gb, ok1 = w_ok && gb1 < n_gb;
  const int p0 = blockIdx.y * kB9Pairs;
  // staging: cell sj of the chunk, pairs sq .. sq + 7 of the tile
  const int sj = threadIdx.x >> 3, sq = (threadIdx.x & 7) * kStage;
  const long long wcol = (long long)tg * gene_block + w;

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
  uint32_t nword = 0;
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
    nword = (w_ok && c0 + lane < end) ? words[(c0 + lane) * wcols + wcol] : 0u;
  };

  load(0);
  for (int q = 0; q < n_q; ++q) {
    __syncthreads();
#pragma unroll
    for (int e = 0; e < kStage; ++e) sB[(sq + e) * kPitch<T> + sj] = v[e];
    __syncthreads();
    const uint32_t word = nword;
    if (q + 1 < n_q) load(q + 1);
    // bit j of ballot s = bitplane s_base + s of chunk cell j; keep the two
    // rows this thread's fragments take
    uint32_t bits0 = 0, bits1 = 0;
#pragma unroll
    for (int s = 0; s < 16; ++s) {
      const uint32_t b = __ballot_sync(kFull, (word >> (s_base + s)) & 1u);
      if (s == g) bits0 = b;
      if (s == g + 8) bits1 = b;
    }
    mma_chunk<T, NT>(part, bits0, bits1, sB, g, t);
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

// The counter hash of singlet_tpu_torch/ops/rngmask.py (reference
// src/singlet.cpp:30-64) on native uint64: rand(i) per cell, then per gene
// the j-mix, the 64-bit add and the final xorshifts.
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

// x % inv == 0 for x = rand(i, j), with inv < 2^16 and two32_mod = 2^32 %
// inv: (hi 2^32 + lo) % inv = ((hi % inv) two32_mod + lo % inv) % inv, which
// stays below 2^32 in uint32
__device__ __forceinline__ bool held_out(uint64_t xi, uint64_t j, uint32_t inv,
                                         uint32_t two32_mod) {
  j ^= j >> 7;
  j ^= j << 23;
  j ^= j >> 8;
  uint64_t x = xi + j;
  x ^= x >> 7;
  x ^= x << 53;
  x ^= x >> 4;
  const uint32_t hi = (uint32_t)(x >> 32), lo = (uint32_t)x;
  return ((hi % inv) * two32_mod + lo % inv) % inv == 0;
}

// B10/B11, first pass: thread idx builds word idx = (cell c, word column
// col) of the call's words (cells, wcols): bit s is the validity-clamped
// test bit of global cell ids[c] at gene (32 t + s) GB + w, col = t GB + w.
// The cell's rand(i) is formed once per word, each (cell, gene) hashed once.
__global__ void __launch_bounds__(256)
hash_words_kernel(const int32_t* __restrict__ ids, int cells, int wcols,
                  int gene_block, int n_gb, uint64_t seed, uint32_t inv,
                  uint32_t two32_mod, long long cells_true,
                  long long genes_true, uint32_t* __restrict__ words) {
  const long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= (long long)cells * wcols) return;
  const int c = (int)(idx / wcols), col = (int)(idx % wcols);
  const int t = col / gene_block, w = col - t * gene_block;
  const int32_t id = ids[c];
  uint32_t word = 0;
  if (id < cells_true) {
    const uint64_t xi = hash_i(seed, (uint64_t)(uint32_t)id);
    for (int s = 0; s < 32; ++s) {
      const int gb = t * 32 + s;
      const long long g = (long long)gb * gene_block + w;
      if (gb >= n_gb || g >= genes_true) break;  // g grows with s
      if (held_out(xi, (uint64_t)(uint32_t)g, inv, two32_mod)) word |= 1u << s;
    }
  }
  words[idx] = word;
}

// B10 and B11 share their first pass: the validity-clamped hashed test mask
// of the call's global cell ids (cells,) int32 into `words` (cells, wcols)
// uint32, a scratch buffer of the wrapper.
cudaError_t hash_words(const int32_t* ids, int cells, int wcols,
                       int gene_block, int n_gb, uint64_t seed,
                       int inv_density, long long cells_true,
                       long long genes_true, uint32_t* words,
                       cudaStream_t s) {
  if (inv_density < 1 || inv_density >= 65536) return cudaErrorInvalidValue;
  const uint32_t inv = (uint32_t)inv_density;
  const uint32_t two32_mod = (uint32_t)((1ull << 32) % inv);
  const long long n = (long long)cells * wcols;
  hash_words_kernel<<<(unsigned)((n + 255) / 256), 256, 0, s>>>(
      ids, cells, wcols, gene_block, n_gb, seed, inv, two32_mod, cells_true,
      genes_true, words);
  return cudaGetLastError();
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

// P (cells, np) int8 or bf16, scales (np, n_scales) float32 (int8 only),
// words (cells, wcols), acc (np, genes_pad) float32 updated in place; `bc`
// divides `scale_block`, which divides `cells`.
int mask_packed_h_t_bits(const void* P, int int8, int np, const float* scales,
                         int n_scales, const uint32_t* words, int cells,
                         int wcols, int gene_block, int n_gb, int genes_pad,
                         int bc, int scale_block, float* acc, void* stream) {
  if (cells <= 0 || np <= 0) return cudaSuccess;
  if (gene_block <= 0 || wcols % gene_block != 0 || bc <= 0 ||
      scale_block % bc != 0 || cells % scale_block != 0) {
    return cudaErrorInvalidValue;
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int w_tiles = (gene_block + kB9Locals - 1) / kB9Locals;
  const dim3 grid((wcols / gene_block) * w_tiles,
                  (np + kB9Pairs - 1) / kB9Pairs);
  if (int8) {
    mph_bits_kernel<uint8_t><<<grid, kThreads, 0, s>>>(
        static_cast<const uint8_t*>(P), np, scales, n_scales, words, cells,
        wcols, gene_block, n_gb, genes_pad, bc, scale_block, acc);
  } else {
    mph_bits_kernel<uint16_t><<<grid, kThreads, 0, s>>>(
        static_cast<const uint16_t*>(P), np, scales, n_scales, words, cells,
        wcols, gene_block, n_gb, genes_pad, bc, scale_block, acc);
  }
  return cudaGetLastError();
}

// B10. P (genes_pad, np) bf16 bit patterns, ids (block,) int32 global cell
// ids, seed the 64-bit mask seed, words (block, wcols) uint32 scratch with
// wcols = n_t * gene_block, out (np, block) float32.
int mask_packed_w_t_hash(const void* P, int np, const int32_t* ids, int block,
                         int wcols, int gene_block, int n_gb, uint64_t seed,
                         int inv_density, long long cells_true,
                         long long genes_true, uint32_t* words, float* out,
                         void* stream) {
  if (block <= 0 || np <= 0) return cudaSuccess;
  if (gene_block <= 0 || wcols % gene_block != 0) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = hash_words(ids, block, wcols, gene_block, n_gb, seed,
                               inv_density, cells_true, genes_true, words, s);
  if (err != cudaSuccess) return err;
  const dim3 grid((block + kB8Cells - 1) / kB8Cells,
                  (np + kB8Pairs - 1) / kB8Pairs);
  mpw_bits_kernel<uint16_t><<<grid, kThreads, 0, s>>>(
      static_cast<const uint16_t*>(P), np, nullptr, words, block, wcols,
      gene_block, n_gb, out);
  return cudaGetLastError();
}

// B11. P (cells, np) bf16, ids (cells,) int32 global cell ids, words (cells,
// wcols) uint32 scratch, acc (np, genes_pad) float32 updated in place, one
// partial per sub-block of `bc` cells (bc divides cells).
int mask_packed_h_t_hash(const void* P, int np, const int32_t* ids, int cells,
                         int wcols, int gene_block, int n_gb, int genes_pad,
                         int bc, uint64_t seed, int inv_density,
                         long long cells_true, long long genes_true,
                         uint32_t* words, float* acc, void* stream) {
  if (cells <= 0 || np <= 0) return cudaSuccess;
  if (gene_block <= 0 || wcols % gene_block != 0 || bc <= 0 ||
      cells % bc != 0) {
    return cudaErrorInvalidValue;
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = hash_words(ids, cells, wcols, gene_block, n_gb, seed,
                               inv_density, cells_true, genes_true, words, s);
  if (err != cudaSuccess) return err;
  const int w_tiles = (gene_block + kB9Locals - 1) / kB9Locals;
  const dim3 grid((wcols / gene_block) * w_tiles,
                  (np + kB9Pairs - 1) / kB9Pairs);
  mph_bits_kernel<uint16_t><<<grid, kThreads, 0, s>>>(
      static_cast<const uint16_t*>(P), np, nullptr, 1, words, cells, wcols,
      gene_block, n_gb, genes_pad, bc, cells, acc);
  return cudaGetLastError();
}

const char* maskgram_bits_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"

// The masked packed-Gram products that share one GEMM, for sm_90a: kernels
// B10 and B11 of the hash route (the test mask hashed from (seed, cell,
// gene)), and B8, B9, B13 and B14 of the bits route (the mask read from
// bitplane words, or from the prebuilt int8 mask of SINGLET_TPU_MASK8=1).
//
// B10 (`mask_packed_w_t_hash`) replaces singlet_tpu/ops/pallas_maskgram.py
// `mask_packed_w_t` (kernel body `_mpw_kernel`), B11 (`mask_packed_h_t_hash`)
// `mask_packed_h_t` (`_mph_kernel`), B8 (`mask_packed_w_t_bits`)
// `mask_packed_w_t_bits` (`_mpw_bits_kernel`), B9 (`mask_packed_h_t_bits`)
// `mask_packed_h_t_bits` (`_mph_bits_body`), B13 (`mask_packed_w_t_m8`)
// `mask_packed_w_t_m8` (`_mpw_m8_kernel`) and B14 (`mask_packed_h_t_m8`)
// `mask_packed_h_t_m8` (`_mph_m8_kernel`). Each is one GEMM, T[M, N] =
// sum_K mask[M, K] P[K, N]:
//
//   B10/B8/B13: M = the call's cells, K = genes
//               out[p, c]  = T[c, p]   (np, block)
//   B11/B9/B14: M = genes, K = the call's cells
//               acc[p, g] += T[g, p]   (np, genes_pad)
//
// What bounds them. At 524,288 cells x 16,384 genes, k = 100 (5050 pairs,
// padded to 5056), one 2048-cell call of B10/B11 is a dense product of 2 x
// 2048 x 16,384 x 5056 = 339 GFLOP: 0.34 ms at the 989 TFLOP/s bf16 peak.
// B8/B13 run the same product per block on int8: 0.17 ms at the 1,979
// TOP/s int8 peak. B9/B14 take a group of 16 such blocks at once on int8:
// 5.43 TOP, 2.74 ms. The mask is 5% dense, so chip_smoke.py's
// bound, which counts only the products the held-out entries need and the
// bytes each call must move, is far lower (B11: 0.2038 ms, the 331 MB carry
// read and written once). A dense design cannot reach that bound; the dense
// product at the peak is its floor.
//
// Design. Each call runs two kernels:
//
// 1. A pass packs the call's mask along the product's K axis into scratch
//    words the wrapper allocates: B10/B8/B13 (block, kwp) words, bit s of
//    word j = gene 32 j + s; B11/B9/B14 (genes_pad, kwp), bit j of word q =
//    cell 32 q + j; kwp = ceil(K / 32) rounded up to 4 (a 16-byte row for
//    TMA), the tails zero.
//    * B10/B11 hash the mask: singlet_tpu_torch/ops/rngmask.py `mask_block`
//      bit for bit (bell_spmm.cu's hash, with x % inv_density taken from the
//      two 32-bit halves as rngmask.u64_mod_small takes it), with the
//      validity clamps: cell ids at or past cells_true and genes at or past
//      genes_true are never held out. Each (cell, gene) is hashed once per
//      call; hashing inside the GEMM would repeat it for every pair tile.
//      B11's pass forms each cell's rand(i) once per block of threads in
//      shared memory and each gene's mix once per thread.
//    * B9's pass transposes the bitplane words: a block stages 256 cells x
//      32 word columns in shared memory, and per 32 cells and column a warp
//      turns the 32 words into 32 gene words by 32 ballots.
//    * B14's pass reads the int8 mask: a block stages 256 cells x 128 genes
//      by 16-byte loads, and per 32 cells and gene one ballot makes the word.
//    Both stage their output so that each row's 8 words leave as one 32-byte
//    sector. Per 32,768-cell group they read 64 MiB (B9) or 512 MiB (B14)
//    and write 64 MiB: 0.04 or 0.17 ms at 3.35 TB/s.
//    * B8's pass transposes a row's bitplane words within each word group:
//      with gene_block % 32 == 0, bit b of word column t GB + 32 u + i is
//      gene (32 t + b) GB + 32 u + i, which is bit i of gene word t GB + b
//      (GB / 32) + u, so the 32 words of columns t GB + 32 u .. + 31 turn
//      by 32 ballots into 32 gene words of the same GB-word span of the
//      row. A warp takes one row's span, stages its words in shared memory
//      (padded, conflict-free) and writes the span out in order. Any other
//      gene_block takes a thread per word and a load per bit.
//    * B13's pass reads the int8 mask: a thread per gene word, 32 bytes by
//      two 16-byte loads, each 4 bytes tested != 0 at once (__vcmpne4).
//    Per 2048-cell block they read 4 MiB (B8) or 32 MiB (B13) and write
//    4 MiB: 0.003 or 0.011 ms at 3.35 TB/s.
// 2. One GEMM, the mask as the A operand in registers built from the packed
//    words and never stored, P the B operand streamed by TMA into a ring of
//    shared-memory stages guarded by mbarriers, one lane of a producer
//    warpgroup keeping it full, consumer warpgroups issuing `wgmma`. There
//    are two instantiations:
//    * bf16 (B10, B11 and bf16 B8/B9/B13/B14): wgmma.mma_async m64n128k16
//      bf16 -> f32 with A built from one word per row and k16 step by the
//      shifts of `mma.sync`'s A fragment (the per-warp layout is the same).
//      P is N-contiguous (K, pairs) in 128-byte-swizzled shared memory, read
//      through the descriptor's transpose bit: two TMA boxes of 64 pairs x
//      128 K and the words (256 rows x 4) per stage, 5 stages. Two consumer
//      warpgroups of 128 rows x 128 pairs each run 16 wgmma per stage in two
//      groups of 8. ptxas serializes wgmma whose A registers are written
//      while a group is in flight, so each group's 32 A registers are built
//      before it starts and it completes before the next group's are built;
//      with the 128 accumulator registers that takes the 232 registers a
//      consumer gets by setmaxnreg from the producer warpgroup. All of K
//      sums in one float32 accumulator: the JAX kernels' sub-block partials
//      are not formed.
//    * int8 (B8/B9/B13/B14 on int8): wgmma.mma_async m64n128k32 s8 x s8 ->
//      s32. int8 wgmma has no transpose, so P reaches shared memory
//      K-major: the wrapper hands over (pairs, K) rows 16 bytes apart (the
//      engine builds its operands so), read as one TMA box of 128 K x 128
//      pairs with the 128-byte swizzle, plus the words (256 rows x 4), per
//      stage. A per row and k32 step is one word expanded to
//      bytes, ((x & 15) * 0x204081) & 0x01010101 four 0/1 bytes at a time.
//      The tile is bf16's, 256 genes x 128 pairs, so that a stage's bytes
//      feed as many products: each of two consumer warpgroups owns 128
//      genes as two int32 partials of 64 registers, built and waited for
//      as bf16's accumulators are. A first design with 128 genes per CTA
//      and the running sums in registers read twice the bytes per product
//      and ran no faster than the bf16 GEMM. The float32 running sums of
//      the tile (128 KiB) live in shared memory beside a ring of 4
//      stages: loaded from the carry once, coalesced, while the ring
//      fills, and stored back once. Per cell sub-block of `bc` cells
//      (ops/maskgram.py b9_sub_block) the first wgmma starts the partials
//      (scale-d 0); at the sub-block's end the group completes and each
//      partial is converted, multiplied by its pair's scale in the
//      sub-block's quantization group and added to its running sum, run =
//      (run + d0) + d1 + ..., with __fmul_rn and __fadd_rn so that nvcc
//      forms no FMA: the bits of the plain version, as the JAX kernel
//      sums. A sub-block
//      that ends inside a stage is handled by masking the A bits: each
//      sub-block the stage touches gets one group of 8 wgmma on its own
//      cells, no cell dropped or counted twice.
//      B8/B13 take the carry-free instantiation (kCarry false): their whole
//      K axis is one exact int32 sum, so the partials stay in registers to
//      the end, there are no running sums, no flush and no carry to read,
//      and the shared memory holds a ring of 8 stages instead. The epilogue
//      converts each sum and multiplies it by its pair's scale, __fmul_rn:
//      the plain version's part.astype(f32) * s, bit for bit.
//    * Coalesced carry: consecutive M rows are consecutive genes (cells in
//      B10), so the epilogue transposes the tile through shared memory and
//      writes out (B10, B8/B13), reads, adds and writes the carry (bf16
//      B11/B9/B14), or writes the running sums (int8 B9/B14), with 16-byte
//      accesses along M.
//    * Raster: bf16 runs the M tiles of one pair tile as neighbours in the
//      grid, so they share its P panel in the L2; int8 takes the tiles in
//      groups of 4 pair tiles, M tile by M tile, so that one wave of 132
//      CTAs reads 4 P panels and 33 word panels from device memory.
//    No split K: two runs give the same bits. A 2048-cell call of B8/B10/
//    B13 at k = 100 is 8 M tiles x 40 pair tiles = 320 CTAs, 2.42 waves of
//    one CTA per SM: the last wave runs 56 of 132 SMs.
//
// The plain versions (ops/maskgram.py) of B10/B11 and bf16 B8/B9/B13/B14
// differ from the kernels only in the order of the f32 sums; on bf16, B8
// and B13 run one GEMM on the same words, so they give the same bits.

#include <cuda.h>  // CUtensorMap and its enums; the encoder comes from the runtime
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBM = 256;                 // mask rows (M) per CTA
constexpr int kBN = 128;                 // pairs (N) per CTA
constexpr int kBK = 128;                 // K per stage: 4 words per row
constexpr int kStages = 5;
constexpr int kConsumers = 2;            // warpgroups, 128 rows each
constexpr int kThreads = (kConsumers + 1) * 128;  // and a producer warpgroup
// registers per thread after setmaxnreg: 2 x 128 x 232 + 128 x 40 <= 64 K
constexpr int kConsumerRegs = 232, kProducerRegs = 40;
constexpr int kWordsPerStage = kBK / 32;
constexpr int kGroupWords = 2;           // words (2 k16 steps) per wgmma group
constexpr int kPHalfBytes = kBK * 64 * 2;        // one TMA box: 128 K x 64 pairs
constexpr int kPBytes = 2 * kPHalfBytes;
constexpr int kWBytes = kBM * kWordsPerStage * 4;
constexpr int kStageBytes = kPBytes + kWBytes;   // a multiple of 1024
constexpr int kEpiPitch = kBN + 4;               // floats: conflict-free
constexpr int kEpiBatch = 16;                    // pair rows per warp in flight
constexpr int kEpiBytes = kConsumers * 128 * kEpiPitch * 4;
constexpr int kSmemBytes = kStages * kStageBytes + 2 * kStages * 8 + 1024;
static_assert(kStageBytes % 1024 == 0, "stages keep the swizzle atoms aligned");
static_assert(kEpiBytes <= kStages * kStageBytes, "the epilogue reuses the ring");

// ---------------------------------------------------------------- helpers

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(count));
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
                   smem_u32(bar)),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_u32(bar))
               : "memory");
}

// wait until the phase of parity `parity` has completed
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%0], %1;\n"
      "@!p bra WAIT;\n"
      "}\n" ::"r"(smem_u32(bar)),
      "r"(parity)
      : "memory");
}

// a 2-D TMA box of `map` at (c0 innermost, c1) into shared memory, counted
// on `bar`
__device__ __forceinline__ void tma_load_2d(void* dst, const CUtensorMap* map,
                                            uint64_t* bar, int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::"
      "bytes [%0], [%1, {%3, %4}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0), "r"(c1)
      : "memory");
}

__device__ __forceinline__ void named_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

// wait until every committed wgmma group of the warpgroup has completed
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// ties the accumulator registers to this point of the program, so that no
// access to them moves across a wgmma fence or wait
__device__ __forceinline__ void fence_regs(float (&d)[64]) {
#pragma unroll
  for (int i = 0; i < 64; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// Shared-memory descriptor of a 128-byte-swizzled, N-contiguous (MN-major)
// B tile: 8-row K groups 1024 bytes apart (SBO), the second 64-pair half
// kPHalfBytes further on (LBO); both in 16-byte units.
__device__ __forceinline__ uint64_t b_desc(uint32_t addr) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(kPHalfBytes >> 4) << 16) |
         (static_cast<uint64_t>(1024 >> 4) << 32) | (1ull << 62);
}

// d (64 x 128 f32, the warpgroup's) += A (64 x 16 bf16, this warp's 16 rows
// in registers) x B (16 x 128 at desc, transposed)
__device__ __forceinline__ void wgmma_m64n128(float (&d)[64],
                                              const uint32_t (&a)[4],
                                              uint64_t desc) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "
      "%30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, "
      "%44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, "
      "%58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]),
        "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]),
        "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),
        "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),
        "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]),
        "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]),
        "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]), "+f"(d[50]),
        "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]),
        "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1));
}

// the low 2 bits of x as two bf16 lanes of 0.0 / 1.0 (bit i -> half i)
__device__ __forceinline__ uint32_t bf16x2(uint32_t x) {
  return ((x & 1u) * 0x3F80u) | (((x >> 1) & 1u) * 0x3F800000u);
}

// ------------------------------------------------------------------- GEMM

// The epilogue's stores of consumer warpgroup c: its 128 rows x kBN pairs,
// staged pair-major in `tile` (pitch kEpiPitch), to out[p * ld + m] (kAdd:
// added to it). Warp wq writes pair rows wq, wq + 4, ..., 16-byte accesses
// along M; kAdd issues the carry loads of kEpiBatch rows before any of
// their stores, so that their latencies overlap (a load after a store to
// the same array would wait for it).
template <bool kAdd>
__device__ __forceinline__ void store_tile(const float* tile, int c, int wq,
                                           int lane, int m0, int n0, int M,
                                           int N, float* __restrict__ out,
                                           long long ld) {
  const int m = m0 + c * 128 + lane * 4;
  const bool vec = (ld % 4 == 0) &&
                   (reinterpret_cast<uintptr_t>(out) % 16 == 0) && m + 3 < M;
  for (int nb = wq; nb < kBN && n0 + nb < N; nb += 4 * kEpiBatch) {
    float4 v[kEpiBatch];
#pragma unroll
    for (int j = 0; j < kEpiBatch; ++j) {
      const int n = nb + 4 * j;
      v[j] = *reinterpret_cast<const float4*>(tile + n * kEpiPitch + lane * 4);
      if (kAdd && vec && n0 + n < N) {
        const float4 o = *reinterpret_cast<const float4*>(
            out + static_cast<long long>(n0 + n) * ld + m);
        v[j].x += o.x;
        v[j].y += o.y;
        v[j].z += o.z;
        v[j].w += o.w;
      }
    }
#pragma unroll
    for (int j = 0; j < kEpiBatch; ++j) {
      const int n = nb + 4 * j;
      if (n0 + n >= N) break;
      float* dst = out + static_cast<long long>(n0 + n) * ld + m;
      if (vec) {
        *reinterpret_cast<float4*>(dst) = v[j];
      } else {
        const float e4[4] = {v[j].x, v[j].y, v[j].z, v[j].w};
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          if (m + e < M) dst[e] = kAdd ? dst[e] + e4[e] : e4[e];
        }
      }
    }
  }
}

// Grid (ceil(M / 256), ceil(N / 128)). Warps 0-7: consumer warpgroup c =
// warp / 4 owns rows c * 128 + sub * 64 + (warp % 4) * 16 .. + 15 (sub = 0,
// 1) of the CTA's 256; warps 8-11: the producer warpgroup, of which one lane
// issues the TMA loads. out[p * ld + m] = T[m, p] (kAdd: += ).
template <bool kAdd>
__global__ void __launch_bounds__(kThreads, 1)
mask_gemm_kernel(const __grid_constant__ CUtensorMap tm_p,
                 const __grid_constant__ CUtensorMap tm_w, int M, int N, int K,
                 float* __restrict__ out, long long ld) {
  extern __shared__ uint8_t smem_raw[];
  const uint32_t pad = (1024 - (smem_u32(smem_raw) & 1023)) & 1023;
  uint8_t* smem = smem_raw + pad;
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + kStages * kStageBytes);
  uint64_t* empty = full + kStages;
  // the warp index, broadcast so that ptxas sees the role split as warp
  // uniform (else it serializes the wgmma)
  const int warp = __shfl_sync(0xffffffffu, threadIdx.x >> 5, 0);
  const int lane = threadIdx.x & 31;
  const int m0 = blockIdx.x * kBM, n0 = blockIdx.y * kBN;
  const int nk = (K + kBK - 1) / kBK;

  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], kConsumers * 4);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp >= kConsumers * 4) {
    // producer warpgroup: one lane keeps the ring full
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(kProducerRegs));
    if (warp == kConsumers * 4 && lane == 0) {
      for (int s = 0; s < nk; ++s) {
        const int slot = s % kStages;
        mbar_wait(&empty[slot], ((s / kStages) & 1) ^ 1);
        uint8_t* st = smem + slot * kStageBytes;
        mbar_expect_tx(&full[slot], kStageBytes);
        tma_load_2d(st, &tm_p, &full[slot], n0, s * kBK);
        tma_load_2d(st + kPHalfBytes, &tm_p, &full[slot], n0 + 64, s * kBK);
        tma_load_2d(st + kPBytes, &tm_w, &full[slot], s * kWordsPerStage, m0);
      }
    }
    return;
  }

  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(kConsumerRegs));
  const int c = warp >> 2, wq = warp & 3;
  const int g = lane >> 2, t = lane & 3;
  float acc[2][64];
#pragma unroll
  for (int sub = 0; sub < 2; ++sub)
#pragma unroll
    for (int i = 0; i < 64; ++i) acc[sub][i] = 0.f;

  for (int s = 0; s < nk; ++s) {
    const int slot = s % kStages;
    mbar_wait(&full[slot], (s / kStages) & 1);
    const uint8_t* st = smem + slot * kStageBytes;
    // this thread's rows g and g + 8 of each 16-row slice: 4 words each
    uint32_t w[2][2][4];
#pragma unroll
    for (int sub = 0; sub < 2; ++sub) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = c * 128 + sub * 64 + wq * 16 + g + h * 8;
        const uint4 v = *reinterpret_cast<const uint4*>(st + kPBytes + r * 16);
        w[sub][h][0] = v.x;
        w[sub][h][1] = v.y;
        w[sub][h][2] = v.z;
        w[sub][h][3] = v.w;
      }
    }
    const uint64_t desc0 = b_desc(smem_u32(st));
    // one wgmma group per kGroupWords words: its A fragments are built
    // before the group starts and it completes before the next group's are
    // built (ptxas serializes the wgmma when an A register is defined while
    // a group is in flight)
#pragma unroll
    for (int grp = 0; grp < kWordsPerStage / kGroupWords; ++grp) {
      uint32_t a[kGroupWords][2][2][4];  // [word][k16 step][sub][register]
#pragma unroll
      for (int kk = 0; kk < kGroupWords; ++kk) {
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          const int k0 = hh * 16 + t * 2;
#pragma unroll
          for (int sub = 0; sub < 2; ++sub) {
            const uint32_t b0 = w[sub][0][grp * kGroupWords + kk];
            const uint32_t b1 = w[sub][1][grp * kGroupWords + kk];
            a[kk][hh][sub][0] = bf16x2(b0 >> k0);
            a[kk][hh][sub][1] = bf16x2(b1 >> k0);
            a[kk][hh][sub][2] = bf16x2(b0 >> (k0 + 8));
            a[kk][hh][sub][3] = bf16x2(b1 >> (k0 + 8));
          }
        }
      }
      // keep the compiler from sinking the shifts past the fence
#pragma unroll
      for (int i = 0; i < kGroupWords * 16; ++i) {
        asm volatile("" : "+r"((&a[0][0][0][0])[i])::"memory");
      }
      fence_regs(acc[0]);
      fence_regs(acc[1]);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kGroupWords; ++kk) {
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          // 16 K rows of 128 bytes per k16 step
          const int step = (grp * kGroupWords + kk) * 2 + hh;
          const uint64_t desc = desc0 + static_cast<uint64_t>(step * 128);
#pragma unroll
          for (int sub = 0; sub < 2; ++sub) {
            wgmma_m64n128(acc[sub], a[kk][hh][sub], desc);
          }
        }
      }
      wgmma_commit();
      wgmma_wait();
      fence_regs(acc[0]);
      fence_regs(acc[1]);
    }
    // the stage's wgmma have completed: free its slot
    __syncwarp();
    if (lane == 0) mbar_arrive(&empty[slot]);
  }

  // epilogue: both warpgroups are done with the ring; each transposes its
  // 128 rows x 128 pairs through shared memory, pair-major
  named_sync(1, kConsumers * 128);
  float* tile = reinterpret_cast<float*>(smem) + c * 128 * kEpiPitch;
#pragma unroll
  for (int sub = 0; sub < 2; ++sub) {
#pragma unroll
    for (int i = 0; i < 64; ++i) {
      const int n = (i >> 2) * 8 + t * 2 + (i & 1);
      const int m = sub * 64 + wq * 16 + g + ((i >> 1) & 1) * 8;
      tile[n * kEpiPitch + m] = acc[sub][i];
    }
  }
  named_sync(2 + c, 128);
  store_tile<kAdd>(tile, c, wq, lane, m0, n0, M, N, out, ld);
}

// --------------------------------------------------------------- int8 GEMM

namespace s8 {

constexpr int kBM = 256;                 // M rows per CTA: 128 per consumer
constexpr int kBN = 128;                 // pairs (N) per CTA
constexpr int kBK = 128;                 // K per stage: one swizzle row
constexpr int kWords = kBK / 32;
constexpr int kPBytes = kBK * kBN;               // one TMA box: 128 pairs x 128 K
constexpr int kWBytes = kBM * kWords * 4;
constexpr int kStageBytes = kPBytes + kWBytes;   // a multiple of 1024
constexpr int kRunPitch = kBM + 4;               // floats: conflict-free
constexpr int kRunBytes = kBN * kRunPitch * 4;   // the running sums
constexpr int kGroupN = 4;               // raster: pair tiles per group
static_assert(kStageBytes % 1024 == 0, "stages keep the swizzle atoms aligned");

// the shared memory of an instantiation: with the carry (B9/B14) 4 stages
// beside the running sums; without (B8/B13) 8 stages, which the epilogue's
// tile reuses
template <bool kCarry>
struct Cfg {
  static constexpr int kStages = kCarry ? 4 : 8;
  static constexpr int kRuns = kCarry ? kRunBytes : 0;
  static constexpr int kSmemBytes =
      kStages * kStageBytes + kRuns + 2 * kStages * 8 + 1024;
  static_assert(kSmemBytes <= 232448, "fits one SM's shared memory");
  static_assert(kCarry || kEpiBytes <= kStages * kStageBytes,
                "the epilogue reuses the ring");
};

// Shared-memory descriptor of a 128-byte-swizzled K-major B tile: rows of
// 128 K bytes, 8-row groups 1024 bytes apart (SBO); the leading offset is
// unused for a swizzled K-major tile (1)
__device__ __forceinline__ uint64_t kmajor_desc(uint32_t addr) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) | (1ull << 16) |
         (static_cast<uint64_t>(1024 >> 4) << 32) | (1ull << 62);
}

// d (64 x 128 s32, the warpgroup's) = (scale_d ? d : 0) + A (64 x 32 s8,
// this warp's 16 rows in registers) x B (32 x 128 at desc, K-major)
__device__ __forceinline__ void wgmma_m64n128k32(int (&d)[64],
                                                 const uint32_t (&a)[4],
                                                 uint64_t desc, int scale_d) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, "
      "{%64, %65, %66, %67}, %68, p;\n"
      "}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]),
        "+r"(d[6]), "+r"(d[7]), "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]),
        "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]), "+r"(d[16]), "+r"(d[17]),
        "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
        "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]),
        "+r"(d[30]), "+r"(d[31]), "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]),
        "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]), "+r"(d[40]), "+r"(d[41]),
        "+r"(d[42]), "+r"(d[43]), "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47]),
        "+r"(d[48]), "+r"(d[49]), "+r"(d[50]), "+r"(d[51]), "+r"(d[52]), "+r"(d[53]),
        "+r"(d[54]), "+r"(d[55]), "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]),
        "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(scale_d));
}

__device__ __forceinline__ void fence_regs(int (&d)[64]) {
#pragma unroll
  for (int i = 0; i < 64; ++i) asm volatile("" : "+r"(d[i])::"memory");
}

// the low 4 bits of x as four 0/1 bytes (bit i -> byte i)
__device__ __forceinline__ uint32_t bytes4(uint32_t x) {
  return ((x & 15u) * 0x204081u) & 0x01010101u;
}

// the bits j of a word with a <= j < b (a and b clamped to [0, 32])
__device__ __forceinline__ uint32_t span_bits(int a, int b) {
  a = min(max(a, 0), 32);
  b = min(max(b, 0), 32);
  const uint32_t below_b = b >= 32 ? 0xffffffffu : (1u << b) - 1u;
  const uint32_t below_a = a >= 32 ? 0xffffffffu : (1u << a) - 1u;
  return below_b & ~below_a;
}

// Grid: one CTA per (M tile, pair tile), in groups of kGroupN pair tiles
// taken M tile by M tile. Warps 0-7: consumer warpgroup c = warp / 4 owns
// rows c * 128 + sub * 64 + (warp % 4) * 16 .. + 15 (sub = 0, 1) of the
// CTA's 256, as two int32 partials of 64 registers; warps 8-11: the
// producer warpgroup, of which one lane issues the TMA loads. kCarry
// (B9/B14): the running sums of the tile (128 pairs x 256 genes) live in
// shared memory, loaded from the carry and stored back coalesced;
// acc[p * ld + m] = the carry plus each sub-block's dequantized partial in
// sub-block order. Else (B8/B13; bc = scale_block = K, one scale per pair):
// acc[p * ld + m] = the whole sum dequantized.
template <bool kCarry>
__global__ void __launch_bounds__(kThreads, 1)
mask_gemm_s8_kernel(const __grid_constant__ CUtensorMap tm_p,
                    const __grid_constant__ CUtensorMap tm_w, int M, int N,
                    int K, const float* __restrict__ scales, int n_scales,
                    int bc, int scale_block, float* __restrict__ acc,
                    long long ld) {
  constexpr int kStages = Cfg<kCarry>::kStages;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t pad = (1024 - (smem_u32(smem_raw) & 1023)) & 1023;
  uint8_t* smem = smem_raw + pad;
  float* runs = reinterpret_cast<float*>(smem + kStages * kStageBytes);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + kStages * kStageBytes +
                                               Cfg<kCarry>::kRuns);
  uint64_t* empty = full + kStages;
  const int warp = __shfl_sync(0xffffffffu, threadIdx.x >> 5, 0);
  const int lane = threadIdx.x & 31;
  const int mt = (M + kBM - 1) / kBM, nt = (N + kBN - 1) / kBN;
  const int per_group = kGroupN * mt;
  const int grp = blockIdx.x / per_group;
  const int first_n = grp * kGroupN;
  const int gn = min(nt - first_n, kGroupN);
  const int local = blockIdx.x - grp * per_group;
  const int m0 = (local / gn) * kBM, n0 = (first_n + local % gn) * kBN;
  const int nk = (K + kBK - 1) / kBK;

  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], kConsumers * 4);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp >= kConsumers * 4) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(kProducerRegs));
    if (warp == kConsumers * 4 && lane == 0) {
      for (int s = 0; s < nk; ++s) {
        const int slot = s % kStages;
        mbar_wait(&empty[slot], ((s / kStages) & 1) ^ 1);
        uint8_t* st = smem + slot * kStageBytes;
        mbar_expect_tx(&full[slot], kStageBytes);
        tma_load_2d(st, &tm_p, &full[slot], s * kBK, n0);
        tma_load_2d(st + kPBytes, &tm_w, &full[slot], s * kWords, m0);
      }
    }
    return;
  }

  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(kConsumerRegs));
  const int c = warp >> 2, wq = warp & 3;
  const int g = lane >> 2, t = lane & 3;
  const int ctid = threadIdx.x;  // 0 .. 255 over both consumer warpgroups
  // kCarry: the running sums start from the carry, coalesced: 64 threads
  // per pair row, 4 genes each
  const int mloc = (ctid & 63) * 4;
  const int mg = m0 + mloc;
  const bool vec = (ld % 4 == 0) &&
                   (reinterpret_cast<uintptr_t>(acc) % 16 == 0) && mg + 3 < M;
  if constexpr (kCarry) {
    for (int n = ctid >> 6; n < kBN; n += 4) {
      float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
      if (n0 + n < N) {
        const float* src = acc + static_cast<long long>(n0 + n) * ld + mg;
        if (vec) {
          v = *reinterpret_cast<const float4*>(src);
        } else {
          if (mg < M) v.x = src[0];
          if (mg + 1 < M) v.y = src[1];
          if (mg + 2 < M) v.z = src[2];
          if (mg + 3 < M) v.w = src[3];
        }
      }
      *reinterpret_cast<float4*>(runs + n * kRunPitch + mloc) = v;
    }
    named_sync(1, kConsumers * 128);
  }

  int part[2][64];
#pragma unroll
  for (int sub = 0; sub < 2; ++sub)
#pragma unroll
    for (int i = 0; i < 64; ++i) part[sub][i] = 0;
  int sb = 0;  // the cell sub-block being summed
  for (int s = 0; s < nk; ++s) {
    const int slot = s % kStages;
    mbar_wait(&full[slot], (s / kStages) & 1);
    const uint8_t* st = smem + slot * kStageBytes;
    // this thread's rows g and g + 8 of each 16-row slice: 4 words each
    uint32_t w[2][2][kWords];
#pragma unroll
    for (int sub = 0; sub < 2; ++sub) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = c * 128 + sub * 64 + wq * 16 + g + h * 8;
        const uint4 v = *reinterpret_cast<const uint4*>(st + kPBytes + r * 16);
        w[sub][h][0] = v.x;
        w[sub][h][1] = v.y;
        w[sub][h][2] = v.z;
        w[sub][h][3] = v.w;
      }
    }
    const uint32_t base = smem_u32(st);
    const int k0 = s * kBK, k_end = min(k0 + kBK, K);
    // each sub-block the stage touches: one group of 8 wgmma on its cells
    while (true) {
      const int sb0 = sb * bc, sb1 = sb0 + bc;
      const int lo = max(k0, sb0), hi = min(k_end, sb1);
      uint32_t a[kWords][2][4];  // [word][sub][register]
#pragma unroll
      for (int kw = 0; kw < kWords; ++kw) {
        const uint32_t keep = span_bits(lo - k0 - 32 * kw, hi - k0 - 32 * kw);
#pragma unroll
        for (int sub = 0; sub < 2; ++sub) {
          const uint32_t b0 = w[sub][0][kw] & keep, b1 = w[sub][1][kw] & keep;
          a[kw][sub][0] = bytes4(b0 >> (t * 4));
          a[kw][sub][1] = bytes4(b1 >> (t * 4));
          a[kw][sub][2] = bytes4(b0 >> (16 + t * 4));
          a[kw][sub][3] = bytes4(b1 >> (16 + t * 4));
        }
      }
#pragma unroll
      for (int i = 0; i < kWords * 8; ++i) {
        asm volatile("" : "+r"((&a[0][0][0])[i])::"memory");
      }
      // a sub-block that starts in this stage starts its partials at zero
      const int keep_d = sb0 < k0 ? 1 : 0;
      fence_regs(part[0]);
      fence_regs(part[1]);
      wgmma_fence();
#pragma unroll
      for (int kw = 0; kw < kWords; ++kw) {
        const uint64_t desc = kmajor_desc(base + kw * 32);
#pragma unroll
        for (int sub = 0; sub < 2; ++sub) {
          wgmma_m64n128k32(part[sub], a[kw][sub], desc, kw == 0 ? keep_d : 1);
        }
      }
      wgmma_commit();
      wgmma_wait();
      fence_regs(part[0]);
      fence_regs(part[1]);
      if (sb1 > k_end) break;  // the sub-block goes on in the next stage
      if constexpr (!kCarry) break;  // K's end: the sums stay in registers
      // the sub-block is complete: dequantize and add into the running
      // sums, in sub-block order (each element is this thread's alone)
      const long long col = sb0 / scale_block;
#pragma unroll
      for (int i = 0; i < 64; ++i) {
        const int n = (i >> 2) * 8 + t * 2 + (i & 1);
        const float sc =
            n0 + n < N
                ? scales[(n0 + n) * static_cast<long long>(n_scales) + col]
                : 0.f;
#pragma unroll
        for (int sub = 0; sub < 2; ++sub) {
          const int m = c * 128 + sub * 64 + wq * 16 + g + ((i >> 1) & 1) * 8;
          float* r = runs + n * kRunPitch + m;
          *r = __fadd_rn(*r, __fmul_rn(__int2float_rn(part[sub][i]), sc));
        }
      }
      ++sb;
      if (sb1 == k_end) break;
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(&empty[slot]);
  }

  named_sync(1, kConsumers * 128);
  if constexpr (!kCarry) {
    // epilogue: both warpgroups are done with the ring; each converts and
    // scales its sums, transposes them through shared memory, pair-major,
    // and writes them out with 16-byte stores along M
    float* tile = reinterpret_cast<float*>(smem) + c * 128 * kEpiPitch;
#pragma unroll
    for (int j = 0; j < 16; ++j) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int n = j * 8 + t * 2 + e;
        const float sc = n0 + n < N ? scales[n0 + n] : 0.f;
#pragma unroll
        for (int h = 0; h < 2; ++h) {
#pragma unroll
          for (int sub = 0; sub < 2; ++sub) {
            const int m = sub * 64 + wq * 16 + g + h * 8;
            tile[n * kEpiPitch + m] =
                __fmul_rn(__int2float_rn(part[sub][j * 4 + h * 2 + e]), sc);
          }
        }
      }
    }
    named_sync(2 + c, 128);
    store_tile<false>(tile, c, wq, lane, m0, n0, M, N, acc, ld);
    return;
  }
  // epilogue: the running sums back to the carry, 16-byte stores along the
  // genes
  for (int n = ctid >> 6; n < kBN && n0 + n < N; n += 4) {
    const float4 v = *reinterpret_cast<const float4*>(runs + n * kRunPitch + mloc);
    float* dst = acc + static_cast<long long>(n0 + n) * ld + mg;
    if (vec) {
      *reinterpret_cast<float4*>(dst) = v;
    } else {
      if (mg < M) dst[0] = v.x;
      if (mg + 1 < M) dst[1] = v.y;
      if (mg + 2 < M) dst[2] = v.z;
      if (mg + 3 < M) dst[3] = v.w;
    }
  }
}

}  // namespace s8

// ------------------------------------------------------------- hash pass

// The counter hash of singlet_tpu_torch/ops/rngmask.py (reference
// src/singlet.cpp:30-64) on native uint64: rand(i) per cell, the j-mix per
// gene, then per (cell, gene) the 64-bit add and the final xorshifts.
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

__device__ __forceinline__ uint64_t gene_mix(uint64_t j) {
  j ^= j >> 7;
  j ^= j << 23;
  j ^= j >> 8;
  return j;
}

// x % inv == 0 for x = rand(i, j), with inv < 2^16 and two32_mod = 2^32 %
// inv: (hi 2^32 + lo) % inv = ((hi % inv) two32_mod + lo % inv) % inv, which
// stays below 2^32 in uint32
__device__ __forceinline__ bool held_out(uint64_t xi, uint64_t jm, uint32_t inv,
                                         uint32_t two32_mod) {
  uint64_t x = xi + jm;
  x ^= x >> 7;
  x ^= x << 53;
  x ^= x >> 4;
  const uint32_t hi = static_cast<uint32_t>(x >> 32);
  const uint32_t lo = static_cast<uint32_t>(x);
  return ((hi % inv) * two32_mod + lo % inv) % inv == 0;
}

// B10's words (cells, kwp): thread idx builds word j of cell c, bit s the
// clamped test bit of (ids[c], gene 32 j + s); rand(i) once per word.
__global__ void __launch_bounds__(256)
hash_w_kernel(const int32_t* __restrict__ ids, int cells, int kwp, int genes,
              uint64_t seed, uint32_t inv, uint32_t two32_mod,
              long long cells_true, long long genes_true,
              uint32_t* __restrict__ words) {
  const long long idx = static_cast<long long>(blockIdx.x) * blockDim.x +
                        threadIdx.x;
  if (idx >= static_cast<long long>(cells) * kwp) return;
  const int c = static_cast<int>(idx / kwp), j = static_cast<int>(idx % kwp);
  const int32_t id = ids[c];
  const long long g_end = genes < genes_true ? genes : genes_true;
  uint32_t word = 0;
  if (id < cells_true) {
    const uint64_t xi = hash_i(seed, static_cast<uint32_t>(id));
    for (int s = 0; s < 32; ++s) {
      const long long g = 32ll * j + s;
      if (g >= g_end) break;
      if (held_out(xi, gene_mix(static_cast<uint32_t>(g)), inv, two32_mod)) {
        word |= 1u << s;
      }
    }
  }
  words[idx] = word;
}

// B11's words (genes, kwp). Block (x, y) covers words 32 x .. + 31 (cells
// 1024 x .. + 1023) of genes 8 y .. + 7; thread (gene row tid / 32, word
// tid % 32). The block's rand(i) go to shared memory once, transposed so
// that a warp reads 32 consecutive values, with a validity word per 32
// cells.
__global__ void __launch_bounds__(256)
hash_h_kernel(const int32_t* __restrict__ ids, int cells, int kwp, int genes,
              uint64_t seed, uint32_t inv, uint32_t two32_mod,
              long long cells_true, long long genes_true,
              uint32_t* __restrict__ words) {
  __shared__ uint64_t xi_s[32 * 32];
  __shared__ uint32_t ok_s[32];
  const int tid = threadIdx.x;
  const long long cell0 = static_cast<long long>(blockIdx.x) * 1024;
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int l = tid + 256 * r;  // warp (tid / 32) of round r: word 8 r + tid / 32
    const long long cell = cell0 + l;
    int32_t id = 0;
    bool ok = false;
    if (cell < cells) {
      id = ids[cell];
      ok = id < cells_true;
    }
    xi_s[(l & 31) * 32 + (l >> 5)] =
        ok ? hash_i(seed, static_cast<uint32_t>(id)) : 0ull;
    const uint32_t b = __ballot_sync(0xffffffffu, ok);
    if ((tid & 31) == 0) ok_s[l >> 5] = b;
  }
  __syncthreads();
  const int q = tid & 31;
  const long long gene = static_cast<long long>(blockIdx.y) * 8 + (tid >> 5);
  const long long wq = static_cast<long long>(blockIdx.x) * 32 + q;
  if (gene >= genes || wq >= kwp) return;
  uint32_t word = 0;
  if (gene < genes_true) {
    const uint64_t jm = gene_mix(static_cast<uint32_t>(gene));
    const uint32_t ok = ok_s[q];
    for (int j = 0; j < 32; ++j) {
      if (((ok >> j) & 1u) && held_out(xi_s[j * 32 + q], jm, inv, two32_mod)) {
        word |= 1u << j;
      }
    }
  }
  words[gene * kwp + wq] = word;
}

cudaError_t hash_pass(bool gene_rows, const int32_t* ids, int cells, int kwp,
                      int genes, uint64_t seed, int inv_density,
                      long long cells_true, long long genes_true,
                      uint32_t* words, cudaStream_t s) {
  if (inv_density < 1 || inv_density >= 65536) return cudaErrorInvalidValue;
  const uint32_t inv = static_cast<uint32_t>(inv_density);
  const uint32_t two32_mod = static_cast<uint32_t>((1ull << 32) % inv);
  if (gene_rows) {
    if (kwp * 32ll < cells) return cudaErrorInvalidValue;
    const dim3 grid((kwp + 31) / 32, (genes + 7) / 8);
    if (grid.y > 65535) return cudaErrorInvalidValue;
    hash_h_kernel<<<grid, 256, 0, s>>>(ids, cells, kwp, genes, seed, inv,
                                       two32_mod, cells_true, genes_true,
                                       words);
  } else {
    if (kwp * 32ll < genes) return cudaErrorInvalidValue;
    const long long n = static_cast<long long>(cells) * kwp;
    hash_w_kernel<<<static_cast<unsigned>((n + 255) / 256), 256, 0, s>>>(
        ids, cells, kwp, genes, seed, inv, two32_mod, cells_true, genes_true,
        words);
  }
  return cudaGetLastError();
}

// ------------------------------------------------------------- K-pack passes

// B9's pass: bitplane words (cells, wcols), wcols = n_t * gene_block, with
// mask(c, gb * GB + w) = (words[c, (gb >> 5) * GB + w] >> (gb & 31)) & 1,
// into (genes_pad, kwp) words packed along the cells. Block (x, y) covers
// word columns 32 x .. + 31 and output words 8 y .. + 7 (cells 256 y ..
// + 255): the 256 x 32 input words staged in shared memory (pitch 33), then
// warp v turns the 32 cells 32 v .. of each column into the column's 32
// gene words by ballots (lane s keeps bitplane s), and the block writes
// each gene's 8 words as one 32-byte sector (the staging reused, pitch 9).
__global__ void __launch_bounds__(256)
kpack_words_kernel(const uint32_t* __restrict__ words, int cells, int wcols,
                   int gene_block, int n_gb, int kwp,
                   uint32_t* __restrict__ out) {
  __shared__ uint32_t buf[1024 * 9];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int col0 = blockIdx.x * 32;
  const long long cell0 = static_cast<long long>(blockIdx.y) * 256;
  const int q0 = blockIdx.y * 8;
  const int col = col0 + lane;
#pragma unroll 4
  for (int j = 0; j < 32; ++j) {
    const long long cl = cell0 + warp * 32 + j;
    buf[(warp * 32 + j) * 33 + lane] =
        (cl < cells && col < wcols) ? words[cl * wcols + col] : 0u;
  }
  __syncthreads();
  uint32_t res[32];
#pragma unroll
  for (int cc = 0; cc < 32; ++cc) {
    const uint32_t w = buf[(warp * 32 + lane) * 33 + cc];
    uint32_t mine = 0;
#pragma unroll
    for (int s = 0; s < 32; ++s) {
      const uint32_t b = __ballot_sync(0xffffffffu, (w >> s) & 1u);
      mine = s == lane ? b : mine;
    }
    res[cc] = mine;
  }
  __syncthreads();
#pragma unroll
  for (int cc = 0; cc < 32; ++cc) buf[(cc * 32 + lane) * 9 + warp] = res[cc];
  __syncthreads();
  // row r = (column cc, bitplane s); two threads per row, 4 words each
  for (int task = threadIdx.x; task < 2048; task += 256) {
    const int r = task >> 1, h = task & 1;
    const int c = col0 + (r >> 5), s = r & 31;
    const int q = q0 + h * 4;
    if (c >= wcols || q >= kwp) continue;
    const int gb = (c / gene_block) * 32 + s;
    if (gb >= n_gb) continue;
    const long long gene = static_cast<long long>(gb) * gene_block +
                           c % gene_block;
    const uint32_t* src = buf + r * 9 + h * 4;
    *reinterpret_cast<uint4*>(out + gene * kwp + q) =
        make_uint4(src[0], src[1], src[2], src[3]);
  }
}

// B14's pass: the int8 0/1 mask (cells, genes) into (genes, kwp) words
// packed along the cells. Block (x, y) covers genes 128 x .. + 127 and
// output words 8 y .. + 7 (cells 256 y .. + 255): 256 rows of 128 mask
// bytes staged in shared memory by 16-byte loads (`vec`: every row 16-byte
// aligned; else byte loads), then warp v forms the word of cells 32 v ..
// of each gene by one ballot, and the block writes each gene's 8 words as
// one 32-byte sector.
__global__ void __launch_bounds__(256)
kpack_m8_kernel(const int8_t* __restrict__ mask, int cells, int genes,
                int kwp, bool vec, uint32_t* __restrict__ out) {
  __shared__ uint32_t buf[256 * 33];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const long long g0 = static_cast<long long>(blockIdx.x) * 128;
  const long long cell0 = static_cast<long long>(blockIdx.y) * 256;
  const int q0 = blockIdx.y * 8;
#pragma unroll 2
  for (int task = threadIdx.x; task < 2048; task += 256) {
    const int r = task >> 3, ch = task & 7;
    const long long cl = cell0 + r, gene = g0 + ch * 16;
    uint4 v = make_uint4(0u, 0u, 0u, 0u);
    if (cl < cells) {
      const int8_t* src = mask + cl * genes + gene;
      if (vec && gene + 15 < genes) {
        v = *reinterpret_cast<const uint4*>(src);
      } else {
        uint32_t e4[4] = {0u, 0u, 0u, 0u};
        for (int e = 0; e < 16 && gene + e < genes; ++e) {
          e4[e >> 2] |= static_cast<uint32_t>(static_cast<uint8_t>(src[e]))
                        << ((e & 3) * 8);
        }
        v = make_uint4(e4[0], e4[1], e4[2], e4[3]);
      }
    }
    uint32_t* dst = buf + r * 33 + ch * 4;
    dst[0] = v.x;
    dst[1] = v.y;
    dst[2] = v.z;
    dst[3] = v.w;
  }
  __syncthreads();
  uint32_t res[4];
#pragma unroll
  for (int m = 0; m < 32; ++m) {
    const uint32_t x = buf[(warp * 32 + lane) * 33 + m];
#pragma unroll
    for (int b = 0; b < 4; ++b) {
      const uint32_t word =
          __ballot_sync(0xffffffffu, ((x >> (8 * b)) & 0xffu) != 0u);
      if (((4 * m + b) & 31) == lane) res[m >> 3] = word;
    }
  }
  __syncthreads();
#pragma unroll
  for (int i = 0; i < 4; ++i) buf[(lane + 32 * i) * 9 + warp] = res[i];
  __syncthreads();
  const int gl = threadIdx.x >> 1, h = threadIdx.x & 1;
  const long long gene = g0 + gl;
  const int q = q0 + h * 4;
  if (gene < genes && q < kwp) {
    const uint32_t* src = buf + gl * 9 + h * 4;
    *reinterpret_cast<uint4*>(out + gene * kwp + q) =
        make_uint4(src[0], src[1], src[2], src[3]);
  }
}

cudaError_t kpack_words(const uint32_t* words, int cells, int wcols,
                        int gene_block, int n_gb, int kwp, uint32_t* out,
                        cudaStream_t s) {
  if (gene_block <= 0 || wcols != ((n_gb + 31) / 32) * gene_block ||
      kwp % 4 != 0 || kwp * 32ll < cells ||
      reinterpret_cast<uintptr_t>(out) % 16 != 0) {
    return cudaErrorInvalidValue;
  }
  const dim3 grid((wcols + 31) / 32, (kwp + 7) / 8);
  if (grid.y > 65535) return cudaErrorInvalidValue;
  kpack_words_kernel<<<grid, 256, 0, s>>>(words, cells, wcols, gene_block,
                                          n_gb, kwp, out);
  return cudaGetLastError();
}

cudaError_t kpack_m8(const int8_t* mask, int cells, int genes, int kwp,
                     uint32_t* out, cudaStream_t s) {
  if (kwp % 4 != 0 || kwp * 32ll < cells ||
      reinterpret_cast<uintptr_t>(out) % 16 != 0) {
    return cudaErrorInvalidValue;
  }
  const bool vec = reinterpret_cast<uintptr_t>(mask) % 16 == 0 &&
                   genes % 16 == 0;
  const dim3 grid((genes + 127) / 128, (kwp + 7) / 8);
  if (grid.y > 65535) return cudaErrorInvalidValue;
  kpack_m8_kernel<<<grid, 256, 0, s>>>(mask, cells, genes, kwp, vec, out);
  return cudaGetLastError();
}

// ------------------------------------------------------------- G-pack passes

constexpr int kGpackWarps = 8;

// B8's pass with gene_block % 32 == 0: bitplane words (cells, wcols), wcols
// = n_t * GB, into (cells, kwp) words packed along the genes. Warp v of
// block x takes task 8 x + v = (cell, word group t), the row's GB-word span
// t GB .. + GB - 1, both in and out: per 32 words 32 u .. + 31 of the span,
// 32 ballots (lane b keeps bitplane b's) give the gene words b (GB / 32) +
// u of the span; staged in shared memory at a pitch of GB / 32 + 1 words
// per bitplane (conflict-free for even GB / 32), then written out in order.
// The word group's missing bitplanes (gene blocks past n_gb) are not
// written; the row's last task zeroes the words past the genes.
__global__ void __launch_bounds__(kGpackWarps * 32)
gpack_words_kernel(const uint32_t* __restrict__ words, int cells, int wcols,
                   int gene_block, int n_gb, int kwp,
                   uint32_t* __restrict__ out) {
  extern __shared__ uint32_t span_s[];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g32 = gene_block >> 5, n_t = wcols / gene_block;
  const long long task = static_cast<long long>(blockIdx.x) * kGpackWarps +
                         warp;
  if (task >= static_cast<long long>(cells) * n_t) return;
  const long long row = task / n_t;
  const int t = static_cast<int>(task - row * n_t);
  const uint32_t* src = words + row * wcols + static_cast<long long>(t) *
                                                   gene_block;
  uint32_t* span = span_s + warp * (gene_block + 32);
  for (int u0 = 0; u0 < g32; u0 += 4) {
    uint32_t w[4];
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      w[q] = u0 + q < g32 ? src[32 * (u0 + q) + lane] : 0u;
    }
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      uint32_t mine = 0;
#pragma unroll
      for (int b = 0; b < 32; ++b) {
        const uint32_t v = __ballot_sync(0xffffffffu, (w[q] >> b) & 1u);
        mine = b == lane ? v : mine;
      }
      if (u0 + q < g32) span[lane * (g32 + 1) + u0 + q] = mine;
    }
  }
  __syncwarp();
  uint32_t* dst = out + row * kwp + static_cast<long long>(t) * gene_block;
  const int n_out = min(32, n_gb - 32 * t) * g32;
  for (int o = lane; o < n_out; o += 32) dst[o] = span[o + o / g32];
  if (t == n_t - 1) {
    for (int j = (n_gb * gene_block) / 32 + lane; j < kwp; j += 32) {
      out[row * kwp + j] = 0u;
    }
  }
}

// B8's pass for any other gene_block: a thread per gene word (cell, j), a
// load per bit.
__global__ void __launch_bounds__(256)
gpack_words_bits_kernel(const uint32_t* __restrict__ words, int cells,
                        int wcols, int gene_block, int n_gb, int kwp,
                        uint32_t* __restrict__ out) {
  const long long idx = static_cast<long long>(blockIdx.x) * blockDim.x +
                        threadIdx.x;
  if (idx >= static_cast<long long>(cells) * kwp) return;
  const long long c = idx / kwp;
  const int j = static_cast<int>(idx - c * kwp);
  const long long genes = static_cast<long long>(n_gb) * gene_block;
  const uint32_t* row = words + c * wcols;
  uint32_t word = 0;
  for (int s = 0; s < 32; ++s) {
    const long long g = 32ll * j + s;
    if (g >= genes) break;
    const int gb = static_cast<int>(g / gene_block);
    const int w = static_cast<int>(g - static_cast<long long>(gb) *
                                           gene_block);
    word |= ((row[(gb >> 5) * gene_block + w] >> (gb & 31)) & 1u) << s;
  }
  out[idx] = word;
}

// bit i = (byte i of x != 0), i = 0..3
__device__ __forceinline__ uint32_t nonzero4(uint32_t x) {
  return ((__vcmpne4(x, 0u) & 0x01010101u) * 0x01020408u) >> 24;
}

// B13's pass: the int8 mask (cells, genes) into (cells, kwp) words packed
// along the genes; a thread per word (cell, j) reads genes 32 j .. + 31,
// by two 16-byte loads where `vec` (every row 16-byte aligned).
__global__ void __launch_bounds__(256)
gpack_m8_kernel(const int8_t* __restrict__ mask, int cells, int genes,
                int kwp, bool vec, uint32_t* __restrict__ out) {
  const long long idx = static_cast<long long>(blockIdx.x) * blockDim.x +
                        threadIdx.x;
  if (idx >= static_cast<long long>(cells) * kwp) return;
  const long long c = idx / kwp;
  const int j = static_cast<int>(idx - c * kwp);
  const long long g0 = 32ll * j;
  const int8_t* src = mask + c * genes + g0;
  uint32_t word = 0;
  if (vec && g0 + 32 <= genes) {
    const uint4 a = *reinterpret_cast<const uint4*>(src);
    const uint4 b = *reinterpret_cast<const uint4*>(src + 16);
    const uint32_t x[8] = {a.x, a.y, a.z, a.w, b.x, b.y, b.z, b.w};
#pragma unroll
    for (int q = 0; q < 8; ++q) word |= nonzero4(x[q]) << (4 * q);
  } else {
    for (int s = 0; s < 32 && g0 + s < genes; ++s) {
      if (src[s] != 0) word |= 1u << s;
    }
  }
  out[idx] = word;
}

cudaError_t gpack_words(const uint32_t* words, int cells, int wcols,
                        int gene_block, int n_gb, int kwp, uint32_t* out,
                        cudaStream_t s) {
  if (gene_block <= 0 || wcols != ((n_gb + 31) / 32) * gene_block ||
      kwp % 4 != 0 || kwp * 32ll < static_cast<long long>(n_gb) * gene_block) {
    return cudaErrorInvalidValue;
  }
  const int span_bytes = kGpackWarps * (gene_block + 32) * 4;
  if (gene_block % 32 == 0 && span_bytes <= 232448) {
    if (span_bytes > 48 * 1024) {
      const cudaError_t err = cudaFuncSetAttribute(
          gpack_words_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
          span_bytes);
      if (err != cudaSuccess) return err;
    }
    const long long tasks =
        static_cast<long long>(cells) * (wcols / gene_block);
    gpack_words_kernel<<<static_cast<unsigned>(
                             (tasks + kGpackWarps - 1) / kGpackWarps),
                         kGpackWarps * 32, span_bytes, s>>>(
        words, cells, wcols, gene_block, n_gb, kwp, out);
  } else {
    const long long n = static_cast<long long>(cells) * kwp;
    gpack_words_bits_kernel<<<static_cast<unsigned>((n + 255) / 256), 256, 0,
                              s>>>(words, cells, wcols, gene_block, n_gb, kwp,
                                   out);
  }
  return cudaGetLastError();
}

cudaError_t gpack_m8(const int8_t* mask, int cells, int genes, int kwp,
                     uint32_t* out, cudaStream_t s) {
  if (kwp % 4 != 0 || kwp * 32ll < genes) return cudaErrorInvalidValue;
  const bool vec = reinterpret_cast<uintptr_t>(mask) % 16 == 0 &&
                   genes % 16 == 0;
  const long long n = static_cast<long long>(cells) * kwp;
  gpack_m8_kernel<<<static_cast<unsigned>((n + 255) / 256), 256, 0, s>>>(
      mask, cells, genes, kwp, vec, out);
  return cudaGetLastError();
}

// ------------------------------------------------------------------- host

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                 void*, const cuuint64_t*, const cuuint64_t*,
                                 const cuuint32_t*, const cuuint32_t*,
                                 CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled from the driver, through the runtime (the library
// links no libcuda)
EncodeTiled encoder() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    if (err == cudaSuccess && found == cudaDriverEntryPointSuccess) {
      fn = reinterpret_cast<EncodeTiled>(p);
    }
  }
  return fn;
}

// T = mask (M x K, words (M, kwp)) @ P (K x N bf16, row stride p_ld) into
// out (N rows of stride ld): stored, or added (kAdd)
template <bool kAdd>
cudaError_t mask_gemm(const void* P, long long p_ld, int N, int K,
                      const uint32_t* words, int kwp, int M, float* out,
                      long long ld, cudaStream_t s) {
  if (p_ld % 8 != 0 || p_ld < N || reinterpret_cast<uintptr_t>(P) % 16 != 0 ||
      kwp % 4 != 0 || kwp * 32ll < K ||
      reinterpret_cast<uintptr_t>(words) % 16 != 0) {
    return cudaErrorInvalidValue;
  }
  const EncodeTiled encode = encoder();
  if (encode == nullptr) return cudaErrorNotSupported;
  const cuuint32_t unit[2] = {1, 1};
  CUtensorMap tm_p, tm_w;
  const cuuint64_t p_dim[2] = {static_cast<cuuint64_t>(N),
                               static_cast<cuuint64_t>(K)};
  const cuuint64_t p_stride[1] = {static_cast<cuuint64_t>(p_ld) * 2};
  const cuuint32_t p_box[2] = {64, kBK};
  if (encode(&tm_p, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, const_cast<void*>(P),
             p_dim, p_stride, p_box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
             CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) != CUDA_SUCCESS) {
    return cudaErrorInvalidValue;
  }
  const cuuint64_t w_dim[2] = {static_cast<cuuint64_t>(kwp),
                               static_cast<cuuint64_t>(M)};
  const cuuint64_t w_stride[1] = {static_cast<cuuint64_t>(kwp) * 4};
  const cuuint32_t w_box[2] = {kWordsPerStage, kBM};
  if (encode(&tm_w, CU_TENSOR_MAP_DATA_TYPE_UINT32, 2,
             const_cast<uint32_t*>(words), w_dim, w_stride, w_box, unit,
             CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE,
             CU_TENSOR_MAP_L2_PROMOTION_NONE,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) != CUDA_SUCCESS) {
    return cudaErrorInvalidValue;
  }
  const dim3 grid((M + kBM - 1) / kBM, (N + kBN - 1) / kBN);
  if (grid.y > 65535) return cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      mask_gemm_kernel<kAdd>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      kSmemBytes);
  if (err != cudaSuccess) return err;
  mask_gemm_kernel<kAdd><<<grid, kThreads, kSmemBytes, s>>>(tm_p, tm_w, M, N, K,
                                                             out, ld);
  return cudaGetLastError();
}

// acc (M rows, N pair rows of stride ld) = (kCarry: the carry plus) per
// sub-block of bc K rows, the dequantized int32 partial of mask (M x K,
// words (M, kwp)) @ P (K x N int8, K-major: N rows of K bytes, pitch apart),
// times scales[p, sub-block start / scale_block]; without the carry bc =
// scale_block = K
template <bool kCarry>
cudaError_t mask_gemm_s8(const void* Pt, long long pitch, int N, int K,
                         const float* scales, int n_scales, int bc,
                         int scale_block, const uint32_t* words, int kwp,
                         int M, float* acc, long long ld, cudaStream_t s) {
  if (pitch % 16 != 0 || pitch < K ||
      reinterpret_cast<uintptr_t>(Pt) % 16 != 0 || kwp % 4 != 0 ||
      kwp * 32ll < K || reinterpret_cast<uintptr_t>(words) % 16 != 0 ||
      bc <= 0 || scale_block % bc != 0 || K % scale_block != 0 ||
      static_cast<long long>(n_scales) * scale_block != K) {
    return cudaErrorInvalidValue;
  }
  const EncodeTiled encode = encoder();
  if (encode == nullptr) return cudaErrorNotSupported;
  const cuuint32_t unit[2] = {1, 1};
  CUtensorMap tm_p, tm_w;
  const cuuint64_t p_dim[2] = {static_cast<cuuint64_t>(K),
                               static_cast<cuuint64_t>(N)};
  const cuuint64_t p_stride[1] = {static_cast<cuuint64_t>(pitch)};
  const cuuint32_t p_box[2] = {s8::kBK, s8::kBN};
  if (encode(&tm_p, CU_TENSOR_MAP_DATA_TYPE_UINT8, 2, const_cast<void*>(Pt),
             p_dim, p_stride, p_box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
             CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) != CUDA_SUCCESS) {
    return cudaErrorInvalidValue;
  }
  const cuuint64_t w_dim[2] = {static_cast<cuuint64_t>(kwp),
                               static_cast<cuuint64_t>(M)};
  const cuuint64_t w_stride[1] = {static_cast<cuuint64_t>(kwp) * 4};
  const cuuint32_t w_box[2] = {s8::kWords, s8::kBM};
  if (encode(&tm_w, CU_TENSOR_MAP_DATA_TYPE_UINT32, 2,
             const_cast<uint32_t*>(words), w_dim, w_stride, w_box, unit,
             CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE,
             CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) != CUDA_SUCCESS) {
    return cudaErrorInvalidValue;
  }
  const long long tiles = static_cast<long long>((M + s8::kBM - 1) / s8::kBM) *
                          ((N + s8::kBN - 1) / s8::kBN);
  if (tiles > 2147483647ll) return cudaErrorInvalidValue;
  if (!kCarry && (bc != K || n_scales != 1)) return cudaErrorInvalidValue;
  constexpr int smem = s8::Cfg<kCarry>::kSmemBytes;
  cudaError_t err = cudaFuncSetAttribute(
      s8::mask_gemm_s8_kernel<kCarry>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  s8::mask_gemm_s8_kernel<kCarry><<<static_cast<unsigned>(tiles), kThreads,
                                    smem, s>>>(
      tm_p, tm_w, M, N, K, scales, n_scales, bc, scale_block, acc, ld);
  return cudaGetLastError();
}

// B9/B14 after their pass: int8 through the int8 GEMM (P K-major, p_ld its
// pitch in bytes), bf16 through the bf16 GEMM adding into the carry (P
// (cells, np), p_ld its row stride in elements)
cudaError_t carry_product(int int8, const void* P, long long p_ld, int np,
                          const float* scales, int n_scales, int cells,
                          int bc, int scale_block, const uint32_t* kwords,
                          int kwp, int genes_pad, float* acc,
                          cudaStream_t s) {
  if (int8) {
    return mask_gemm_s8<true>(P, p_ld, np, cells, scales, n_scales, bc,
                              scale_block, kwords, kwp, genes_pad, acc,
                              genes_pad, s);
  }
  return mask_gemm<true>(P, p_ld, np, cells, kwords, kwp, genes_pad, acc,
                         genes_pad, s);
}

// B8/B13 after their pass: out (np, block) = the block's mask (words
// (block, kwp) along the genes) @ P, int8 through the carry-free int8 GEMM
// (P K-major, p_ld its pitch in bytes) times scales[p], bf16 through the
// bf16 GEMM (P (genes_pad, np), p_ld its row stride in elements)
cudaError_t w_product(int int8, const void* P, long long p_ld, int np,
                      const float* scales, const uint32_t* kwords, int kwp,
                      int block, int genes_pad, float* out, cudaStream_t s) {
  if (int8) {
    return mask_gemm_s8<false>(P, p_ld, np, genes_pad, scales, 1, genes_pad,
                               genes_pad, kwords, kwp, block, out, block, s);
  }
  return mask_gemm<false>(P, p_ld, np, genes_pad, kwords, kwp, block, out,
                          block, s);
}

}  // namespace

extern "C" {

// The hash pass alone: the call's K-packed words. gene_rows 0: B10's
// (cells, kwp), K = genes; 1: B11's (genes, kwp), K = cells. ids (cells,)
// int32 global cell ids, seed the 64-bit mask seed, words uint32 with kwp a
// multiple of 4 covering K.
int mask_hash_words(int gene_rows, const int32_t* ids, int cells, int genes,
                    int kwp, uint64_t seed, int inv_density,
                    long long cells_true, long long genes_true,
                    uint32_t* words, void* stream) {
  if (cells <= 0 || genes <= 0) return cudaSuccess;
  return hash_pass(gene_rows != 0, ids, cells, kwp, genes, seed, inv_density,
                   cells_true, genes_true, words,
                   static_cast<cudaStream_t>(stream));
}

// B10. P (genes_pad, np) bf16 bit patterns, rows p_ld apart (a multiple of
// 8, the base 16-byte aligned), ids (block,) int32, words (block, kwp)
// uint32 scratch, out (np, block) float32.
int mask_packed_w_t_hash(const void* P, long long p_ld, int np,
                         const int32_t* ids, int block, int genes_pad,
                         int kwp, uint64_t seed, int inv_density,
                         long long cells_true, long long genes_true,
                         uint32_t* words, float* out, void* stream) {
  if (block <= 0 || np <= 0 || genes_pad <= 0) return cudaSuccess;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = hash_pass(false, ids, block, kwp, genes_pad, seed,
                              inv_density, cells_true, genes_true, words, s);
  if (err != cudaSuccess) return err;
  return mask_gemm<false>(P, p_ld, np, genes_pad, words, kwp, block, out,
                          block, s);
}

// B11. P (cells, np) bf16, rows p_ld apart, ids (cells,) int32, words
// (genes_pad, kwp) uint32 scratch, acc (np, genes_pad) float32 updated in
// place.
int mask_packed_h_t_hash(const void* P, long long p_ld, int np,
                         const int32_t* ids, int cells, int genes_pad, int kwp,
                         uint64_t seed, int inv_density, long long cells_true,
                         long long genes_true, uint32_t* words, float* acc,
                         void* stream) {
  if (cells <= 0 || np <= 0 || genes_pad <= 0) return cudaSuccess;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = hash_pass(true, ids, cells, kwp, genes_pad, seed,
                              inv_density, cells_true, genes_true, words, s);
  if (err != cudaSuccess) return err;
  return mask_gemm<true>(P, p_ld, np, cells, words, kwp, genes_pad, acc,
                         genes_pad, s);
}

// B9's pass alone: bitplane words (cells, wcols) into (genes_pad, kwp) words
// packed along the cells, kwp a multiple of 4 covering the cells.
int mask_kpack_words(const uint32_t* words, int cells, int wcols,
                     int gene_block, int n_gb, int kwp, uint32_t* out,
                     void* stream) {
  if (cells <= 0 || n_gb <= 0) return cudaSuccess;
  return kpack_words(words, cells, wcols, gene_block, n_gb, kwp, out,
                     static_cast<cudaStream_t>(stream));
}

// B14's pass alone: the int8 mask (cells, genes_pad) into (genes_pad, kwp)
// words packed along the cells.
int mask_kpack_m8(const int8_t* mask, int cells, int genes_pad, int kwp,
                  uint32_t* out, void* stream) {
  if (cells <= 0 || genes_pad <= 0) return cudaSuccess;
  return kpack_m8(mask, cells, genes_pad, kwp, out,
                  static_cast<cudaStream_t>(stream));
}

// B9. int8 != 0: P (np, p_ld) int8 K-major, the call's cells along each
// row, scales (np, n_scales) float32; else P (cells, np) bf16, rows p_ld
// apart. words (cells, wcols) uint32 bitplane words, kwords (genes_pad,
// kwp) uint32 scratch, acc (np, genes_pad) float32 updated in place; `bc`
// divides `scale_block`, which divides `cells`.
int mask_packed_h_t_bits(int int8, const void* P, long long p_ld, int np,
                         const float* scales, int n_scales,
                         const uint32_t* words, int cells, int wcols,
                         int gene_block, int n_gb, int genes_pad, int bc,
                         int scale_block, uint32_t* kwords, int kwp,
                         float* acc, void* stream) {
  if (cells <= 0 || np <= 0 || genes_pad <= 0) return cudaSuccess;
  if (genes_pad != n_gb * gene_block) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = kpack_words(words, cells, wcols, gene_block, n_gb, kwp,
                                kwords, s);
  if (err != cudaSuccess) return err;
  return carry_product(int8, P, p_ld, np, scales, n_scales, cells, bc,
                       scale_block, kwords, kwp, genes_pad, acc, s);
}

// B14: B9 with the mask read from the prebuilt int8 0/1 mask (cells,
// genes_pad).
int mask_packed_h_t_m8(int int8, const void* P, long long p_ld, int np,
                       const float* scales, int n_scales, const int8_t* mask,
                       int cells, int genes_pad, int bc, int scale_block,
                       uint32_t* kwords, int kwp, float* acc, void* stream) {
  if (cells <= 0 || np <= 0 || genes_pad <= 0) return cudaSuccess;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = kpack_m8(mask, cells, genes_pad, kwp, kwords, s);
  if (err != cudaSuccess) return err;
  return carry_product(int8, P, p_ld, np, scales, n_scales, cells, bc,
                       scale_block, kwords, kwp, genes_pad, acc, s);
}

// B8's pass alone: bitplane words (cells, wcols) into (cells, kwp) words
// packed along the genes, kwp a multiple of 4 covering n_gb * gene_block.
int mask_gpack_words(const uint32_t* words, int cells, int wcols,
                     int gene_block, int n_gb, int kwp, uint32_t* out,
                     void* stream) {
  if (cells <= 0 || n_gb <= 0) return cudaSuccess;
  return gpack_words(words, cells, wcols, gene_block, n_gb, kwp, out,
                     static_cast<cudaStream_t>(stream));
}

// B13's pass alone: the int8 mask (cells, genes_pad) into (cells, kwp)
// words packed along the genes.
int mask_gpack_m8(const int8_t* mask, int cells, int genes_pad, int kwp,
                  uint32_t* out, void* stream) {
  if (cells <= 0 || genes_pad <= 0) return cudaSuccess;
  return gpack_m8(mask, cells, genes_pad, kwp, out,
                  static_cast<cudaStream_t>(stream));
}

// B8. int8 != 0: P (np, p_ld) int8 K-major, the genes along each row,
// scales (np,) float32; else P (genes_pad, np) bf16, rows p_ld apart. words
// (block, wcols) uint32 bitplane words, kwords (block, kwp) uint32 scratch,
// out (np, block) float32.
int mask_packed_w_t_bits(int int8, const void* P, long long p_ld, int np,
                         const float* scales, const uint32_t* words,
                         int block, int wcols, int gene_block, int n_gb,
                         uint32_t* kwords, int kwp, float* out,
                         void* stream) {
  if (block <= 0 || np <= 0 || n_gb <= 0) return cudaSuccess;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = gpack_words(words, block, wcols, gene_block, n_gb, kwp,
                                kwords, s);
  if (err != cudaSuccess) return err;
  return w_product(int8, P, p_ld, np, scales, kwords, kwp, block,
                   n_gb * gene_block, out, s);
}

// B13: B8 with the mask read from the block's rows of the prebuilt int8
// 0/1 mask (block, genes_pad).
int mask_packed_w_t_m8(int int8, const void* P, long long p_ld, int np,
                       const float* scales, const int8_t* mask, int block,
                       int genes_pad, uint32_t* kwords, int kwp, float* out,
                       void* stream) {
  if (block <= 0 || np <= 0 || genes_pad <= 0) return cudaSuccess;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = gpack_m8(mask, block, genes_pad, kwp, kwords, s);
  if (err != cudaSuccess) return err;
  return w_product(int8, P, p_ld, np, scales, kwords, kwp, block, genes_pad,
                   out, s);
}

const char* maskgram_gemm_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"

// Masked packed-Gram products of the hash route: kernels B10 and B11 of the
// port, with the test mask hashed from (seed, cell, gene), for sm_90a.
//
// B10 (`mask_packed_w_t_hash`) replaces singlet_tpu/ops/pallas_maskgram.py
// `mask_packed_w_t` (kernel body `_mpw_kernel`) and B11
// (`mask_packed_h_t_hash`) replaces `mask_packed_h_t` (`_mph_kernel`).
// Both are one GEMM, T[M, N] = sum_K mask[M, K] P[K, N], with P bf16
// row-major (K, pairs) and float32 sums:
//
//   B10:  M = the call's cells, K = genes   out[p, c]  = T[c, p]  (np, block)
//   B11:  M = genes, K = the call's cells   acc[p, g] += T[g, p]  (np, genes_pad)
//
// What bounds them. At 524,288 cells x 16,384 genes, k = 100 (5050 pairs,
// padded to 5056), one 2048-cell call is a dense product of 2 x 2048 x
// 16,384 x 5056 = 339 GFLOP: 0.34 ms at the 989 TFLOP/s bf16 peak. The mask
// is 5% dense, so chip_smoke.py's bound, which counts only the products the
// held-out entries need and the bytes each call must move, is far lower:
// 0.0617 ms (B10, by bytes) and 0.2038 ms (B11, the 331 MB carry read and
// written once). A dense design cannot reach that bound; 0.34 ms is its
// floor.
//
// Design. Each call runs two kernels:
//
// 1. The hash pass packs the call's mask along the product's K axis into
//    scratch words the wrapper allocates: B10 (block, kwp) words, bit s of
//    word j = gene 32 j + s; B11 (genes_pad, kwp), bit j of word q = cell
//    32 q + j; kwp = ceil(K / 32) rounded up to 4 (a 16-byte row for TMA),
//    the tails zero. The hash is singlet_tpu_torch/ops/rngmask.py
//    `mask_block` bit for bit (bell_spmm.cu's hash, with x % inv_density
//    taken from the two 32-bit halves as rngmask.u64_mod_small takes it),
//    with the validity clamps: cell ids at or past cells_true and genes at or
//    past genes_true are never held out. Each (cell, gene) is hashed once per
//    call; hashing inside the GEMM would repeat it for every pair tile. B11's
//    pass forms each cell's rand(i) once per block of threads in shared
//    memory and each gene's mix once per thread.
// 2. One GEMM kernel, a template with a store / add flag, answers the four
//    faults of the earlier design, bf16 B8/B9 (maskgram_bits.cu) behind a
//    hash pass into their bitplane words:
//    * `wgmma` in place of `mma.sync`: wgmma.mma_async m64n128k16 bf16 ->
//      f32, the mask as the A operand in registers, built from one word per
//      row and k16 step by the shifts of `mma.sync`'s A fragment (the per-warp
//      layout is the same), never stored. P is the B operand, N-contiguous in
//      128-byte-swizzled shared memory, read through the descriptor's
//      transpose bit.
//    * The tensor cores do not wait on staging: one lane of a producer
//      warpgroup streams P (two TMA boxes of 64 pairs x 128 K) and the mask
//      words (256 rows x 4 words) into a ring of 5 stages guarded by
//      mbarriers; TMA's zero fill covers the ragged K and pair edges. Two
//      consumer warpgroups each run 16 wgmma per stage, in two groups of 8.
//      ptxas serializes wgmma whose A registers are written while a group
//      is in flight, so each group's 32 A registers are built before it
//      starts and it completes before the next group's are built; with the
//      128 accumulator registers that takes the 232 registers a consumer
//      gets by setmaxnreg from the producer warpgroup.
//    * Coalesced stores: consecutive M rows are consecutive cells or genes,
//      so the epilogue transposes the accumulator tile through shared memory
//      and writes out (B10), or reads, adds and writes the carry (B11), with
//      16-byte accesses along M; B11 reads and writes each carry element once
//      per call, with no warp ballots, and keeps the loads of 16 rows in
//      flight before their stores.
//    * Large tiles: 256 mask rows x 128 pairs per CTA (FLOPs per byte of P
//      equal the tile's M); the M tiles of one pair tile are neighbours in
//      the grid, so they share its P panel in the L2. No split K: two runs
//      give the same bits.
//
// B11 sums all the call's cells in one float32 accumulator: the JAX
// kernel's 1024-cell sub-block partials are not formed. The plain versions
// (ops/maskgram.py) differ from the kernels only in the order of the f32
// sums.

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
  // warp wq writes pair rows wq, wq + 4, ..., 16-byte accesses along M;
  // B11 issues the carry loads of kEpiBatch rows before any of their
  // stores, so that their latencies overlap (a load after a store to the
  // same array would wait for it)
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

const char* maskgram_hash_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"

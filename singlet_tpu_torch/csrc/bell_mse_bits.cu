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
// What bounds it. The TPU densifies every (gene block x cells) tile and
// predicts all of it on its matrix unit, because it cannot gather; only
// the held-out entries count (1 / inv_density of them), so this kernel
// predicts only those: at 524,288 cells x 16,384 genes, k = 100, 430M
// entries, 86 GFLOP (1.3 ms at the 67 TFLOP/s float32 peak), against
// about 5.2 GiB of planes, words and H to read (1.7 ms at 3.35 TB/s). The
// parent took a warp per cell and read, for every held-out entry, Wd's row
// of k floats from L2 (172 GB through L1 and L2 at 524k cells). Here a
// block owns a tile of C cells and reads each of Wd's rows once per tile
// from L2, through shared memory:
//
// - a producer warp walks the gene blocks in order and each one's
//   sub-blocks of R genes in order (`b7_plan` in ops/bell_cuda.py picks
//   C and R): it brings Wd's (R, kp) slice into one of two buffers by a
//   bulk copy (TMA), counted on the buffer's mbarrier, and refills a
//   buffer once the walkers' mbarrier says they are done with it;
// - each of W <= 16 walker warps owns CPW cells (C = W CPW), keeps their
//   H rows in registers for the whole call (lane l: columns l, l + 32,
//   ...; the cell at hand in h[0], the rows rotating after each cell) and
//   copies its own cells' test bits and slot rows of the next gene block
//   into the other of two buffers by cp.async (rows of C + 1, so that a
//   warp reads one cell's slots from distinct banks); per step and cell it
//   lists the sub-block's held-out genes in ascending order (a lane per
//   bit, its place the count of the set bits below it), writes the cell's
//   live slots of the sub-block into a row of (tag, value) pairs (a pair
//   of an older (cell, sub-block) reads as 0, so nothing is cleared), and
//   forms the dots of eight listed genes at a time (four for the last
//   four or fewer) with Wd's rows from shared memory.
//
// The test bits come from a pass (`b7_bits_kernel`) that transposes the
// words into each cell's bits of each gene block, cell rows contiguous
// ([gb][cell][word], bm_pitch words a cell), so a cell's bits of a
// sub-block are one load; the words themselves hold a bit of 32 gene
// blocks each and would be re-read once per gene block. Wd comes permuted
// by the caller (ops/bell_cuda.py `b7_wd_operand`): its row of kp = 32 NPL
// floats holds lane l's columns l + 32 s, s = 4q .. 4q + 3, at 128 q + 4 l,
// zeros past k, so that a lane reads its part of a row with NPL / 4
// 16-byte loads and a warp's load is 512 contiguous bytes (1 or 2 floats a
// lane for NPL = 1, 2).
//
// The parent's bits. Each lane forms its part of the dot as the parent
// did, one fmaf chain over its columns l, l + 32, ... in order (the zeros
// past k leave it as it is: the chain starts at +0 and cannot reach -0),
// and the 32 parts are summed by the parent's xor butterfly 16, 8, 4, 2,
// 1. Eight entries at a time the first three levels are a reduce-scatter
// (two for four entries): at each, a lane keeps half of its entries and
// adds its partner's parts of them, so each level adds the same two
// partial sums as the parent's butterfly did (addition commutes), with 9
// shuffles for 8 entries in place of 40. Per cell the squared errors are
// summed `s = fmaf(diff, diff, s)` over its held-out genes in ascending
// order (gene blocks, sub-blocks, genes), as the parent did, and the
// count is the number of them (an integer below 2^24, exact in float32):
// the outputs are the parent's bit for bit. A gene that a cell holds twice
// in its slots takes one of the two values, as in the parent. Built
// without --use_fast_math.
//
// What bounds this design (H100): the walkers' issue and shared-memory
// wavefronts, about 20 cycles of an SM per entry in all (4 wavefronts of
// the dot's row at k = 100, the shuffles, the list and the slot rows, and
// the instructions around them), and at small tiles or large k Wd's
// stream through L2 (a tile reads 8.4 MB of it at k = 100).

#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr unsigned kFull = 0xffffffffu;
// walkers a block, and a producer: 16 warps at up to 128 registers, or 17
// at 96 where a walker's H rows take at most 16 floats a lane
__host__ __device__ constexpr int max_walkers(int npl, int cpw) {
  return npl * cpw <= 16 ? 16 : 15;
}
constexpr int kBatch = 8;             // entries a reduce-scatter
constexpr size_t kSmemMax = 232448;

// ---------------------------------------------------------------- the pass

// words[c, (gb >> 5) * GB + l] bit (gb & 31) becomes bit (l & 31) of
// bm[gb][c][l >> 5] (bm_pitch words a cell, zero past the gene block). A
// block takes 32 cells and 256 genes of one word group: its warps load the
// cells' words into shared memory along the rows, thread (warp jj, lane
// c) transposes cell c's 32 words of genes 32 jj .. 32 jj + 31 in
// registers (five block swaps), and the block stores each gene block's
// 8 words a cell through shared memory, 32 contiguous bytes a cell.
constexpr int kBmCells = 32;
constexpr int kBmWords = 8;   // 32-gene words a block, one per warp

__global__ void __launch_bounds__(256)
b7_bits_kernel(const uint32_t* __restrict__ words, long long wld, int cells,
               int cells_pad, int n_gb, int gene_block, int bm_pitch,
               uint32_t* __restrict__ bm) {
  __shared__ uint32_t tile[kBmCells * (32 * kBmWords + 1)];
  const int n_t = (n_gb + 31) / 32;
  const int n_jb = bm_pitch / kBmWords;
  const int jb = (int)(blockIdx.x % n_jb);
  const int t = (int)(blockIdx.x / n_jb % n_t);
  const long long c0 = (long long)(blockIdx.x / n_jb / n_t) * kBmCells;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  constexpr int kRow = 32 * kBmWords + 1;
  for (int r = warp; r < kBmCells; r += 8) {
    const long long c = c0 + r;
    for (int x = lane; x < 32 * kBmWords; x += 32) {
      const int l = 32 * kBmWords * jb + x;
      tile[r * kRow + x] =
          c < cells && l < gene_block
              ? __ldg(words + c * wld + (long long)t * gene_block + l)
              : 0u;
    }
  }
  __syncthreads();
  uint32_t m[32];   // m[r] bit b: gene 32 warp + r, gene block 32 t + b
#pragma unroll
  for (int r = 0; r < 32; ++r) m[r] = tile[lane * kRow + 32 * warp + r];
  uint32_t mask = 0x0000ffffu;
#pragma unroll
  for (int h = 16; h != 0; h >>= 1, mask ^= mask << h) {
#pragma unroll
    for (int r = 0; r < 32; ++r) {
      if (r & h) continue;
      const uint32_t x = ((m[r] >> h) ^ m[r + h]) & mask;
      m[r] ^= x << h;
      m[r + h] ^= x;
    }
  }
  __syncthreads();
  // out[b][c][j] = m[b] of thread (warp j, lane c), then the stores
  uint32_t* out = tile;
#pragma unroll
  for (int b = 0; b < 32; ++b) out[(b * 32 + lane) * kBmWords + warp] = m[b];
  __syncthreads();
  const int c = threadIdx.x >> 3;
  const int j = threadIdx.x & 7;
  if (c0 + c >= cells_pad) return;
  for (int b = 0; b < 32; ++b) {
    const int gb = 32 * t + b;
    if (gb >= n_gb) break;
    bm[((long long)gb * cells_pad + c0 + c) * bm_pitch + kBmWords * jb + j] =
        out[(b * 32 + c) * kBmWords + j];
  }
}

// ------------------------------------------------------------ the kernel

struct Args {
  const int32_t* li;     // planes, row r at r * ld
  const float* lv;
  long long ld;
  int n_gb, width, cells, gene_block;
  const uint32_t* bm;    // the pass's bits: (n_gb, cells_pad, bm_pitch)
  int cells_pad, bm_pitch;
  const float* wp;       // Wd permuted: (n_gb * gene_block, kp)
  const float* H;        // (cells, k)
  int k, kp;
  float* out;            // (2, cells)
  int walkers, rows_sb, n_sb;   // W, R, sub-blocks a gene block
};

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
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(
                   smem_u32(bar))
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

// `bytes` (a multiple of 16) from device memory to shared memory, counted
// on `bar`
__device__ __forceinline__ void bulk_load(void* dst, const void* src,
                                          uint32_t bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1], %2, [%3];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(src)), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src)
               : "memory");
}

// shared memory of a block (ops/bell_cuda.py `b7_smem` is the same): two
// buffers of Wd's (R, kp) slice, two of the tile's bits of a gene block
// (C bm_pitch words), a walker's dense row of R floats, 8 of scratch and
// a list of R + 8 genes,
// two buffers of the tile's slot rows of a gene block (ids, then values:
// width rows of C + 1), four mbarriers
struct Layout {
  size_t wd, bits, dense, li, lv, bars, total;   // byte offsets
};

__host__ __device__ inline Layout b7_layout(int rows_sb, int kp, int cells,
                                            int bm_pitch, int walkers,
                                            int width) {
  Layout L{};
  size_t off = 0;
  L.wd = off;
  off += 2 * (size_t)rows_sb * kp * 4;
  L.bits = off;
  off += 2 * (size_t)cells * bm_pitch * 4;
  L.dense = off;
  off += (size_t)walkers * (3 * rows_sb + 2 * kBatch) * 4;
  L.li = off;
  off += 2 * (size_t)width * (cells + 1) * 4;
  L.lv = off;
  off += 2 * (size_t)width * (cells + 1) * 4;
  off = (off + 15) & ~(size_t)15;
  L.bars = off;
  off += 4 * 8;
  L.total = off;
  return L;
}

// NPL: columns a lane (k <= 32 NPL; 1, 2, or a multiple of 4), CPW: cells
// a walker (CPW NPL <= 32 floats of H in registers, or 2 cells)
template <int NPL, int CPW>
__global__ void __launch_bounds__((max_walkers(NPL, CPW) + 1) * 32, 1)
b7_kernel(const Args a) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int W = a.walkers;
  const int C = W * CPW;
  const int R = a.rows_sb;
  const int kp = a.kp;
  const int width = a.width;
  const Layout L = b7_layout(R, kp, C, a.bm_pitch, W, width);
  float* wd_s = reinterpret_cast<float*>(smem + L.wd);
  uint32_t* bits_s = reinterpret_cast<uint32_t*>(smem + L.bits);
  int32_t* li_s = reinterpret_cast<int32_t*>(smem + L.li);
  float* lv_s = reinterpret_cast<float*>(smem + L.lv);
  // per buffer: Wd's slice landed; the walkers are done with it
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + L.bars);
  uint64_t* empty = full + 2;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const long long c0 = (long long)blockIdx.x * C;
  const int steps = a.n_gb * a.n_sb;
  const int plane = width * (C + 1);   // ints of one buffer of slot rows

  if (threadIdx.x == 0) {
    for (int b = 0; b < 2; ++b) {
      mbar_init(&full[b], 1);    // the producer's expect_tx
      mbar_init(&empty[b], W);   // each walker
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp == W) {
    // the producer: Wd's sub-block slices, in order, into the buffer the
    // walkers are done with
    for (int t = 0; t < steps; ++t) {
      const int buf = t & 1;
      const int gb = t / a.n_sb;
      const int sb = t - gb * a.n_sb;
      if (t >= 2) mbar_wait(&empty[buf], ((t - 2) >> 1) & 1);
      const int rows = min(R, a.gene_block - sb * R);
      const uint32_t wd_bytes = (uint32_t)rows * kp * 4;
      if (lane == 0) {
        mbar_expect_tx(&full[buf], wd_bytes);
        bulk_load(wd_s + (size_t)buf * R * kp,
                  a.wp + ((long long)gb * a.gene_block + sb * R) * kp,
                  wd_bytes, &full[buf]);
      }
    }
    return;
  }

  // a walker: cells c0 + warp CPW + j, j < CPW; their H rows in registers
  float h[CPW][NPL];
#pragma unroll
  for (int j = 0; j < CPW; ++j) {
    const long long c = c0 + warp * CPW + j;
#pragma unroll
    for (int s = 0; s < NPL; ++s) {
      const int col = s * 32 + lane;
      h[j][s] = c < a.cells && col < a.k ? a.H[c * a.k + col] : 0.f;
    }
  }
  float s_mine = 0.f, n_mine = 0.f;   // lane j: cell j's sums
  // the cell's values at the sub-block's genes, each with the tag of the
  // (cell, sub-block) that wrote it: a stale tag reads as 0, so nothing is
  // cleared
  uint2* dense = reinterpret_cast<uint2*>(smem + L.dense +
                                          (size_t)warp *
                                              (3 * R + 2 * kBatch) * 4);
  float* scratch = reinterpret_cast<float*>(dense + R);
  int* list = reinterpret_cast<int*>(scratch + kBatch);   // R + 8 ints
  for (int i = lane; i < R; i += 32) dense[i] = make_uint2(0u, 0u);
  for (int i = lane; i < R + kBatch; i += 32) list[i] = 0;
  __syncwarp();
  unsigned tag = 0;
  const unsigned below = (1u << lane) - 1u;
  // the walker's own cells' bits and slot rows of gene block g into buffer
  // g & 1 (cp.async, one group): no other warp reads them
  const int cl0 = warp * CPW;
  const int cvw = (int)max(0LL, min((long long)CPW, a.cells - c0 - cl0));
  auto copy_planes = [&](int g) {
    uint32_t* bd = bits_s + (size_t)(g & 1) * C * a.bm_pitch +
                   (size_t)cl0 * a.bm_pitch;
    const uint32_t* bsrc =
        a.bm + ((long long)g * a.cells_pad + c0 + cl0) * a.bm_pitch;
    for (int e = 4 * lane; e < CPW * a.bm_pitch; e += 128) {
      cp_async16(bd + e, bsrc + e);
    }
    int32_t* li_d = li_s + (size_t)(g & 1) * plane + cl0;
    float* lv_d = lv_s + (size_t)(g & 1) * plane + cl0;
    for (int e = lane; e < width * CPW; e += 32) {
      const int w = e / CPW;
      const int j = e - w * CPW;
      if (j < cvw) {
        const long long r = ((long long)g * width + w) * a.ld + c0 + cl0 + j;
        cp_async4(li_d + w * (C + 1) + j, a.li + r);
        cp_async4(lv_d + w * (C + 1) + j, a.lv + r);
      }
    }
    cp_async_commit();
  };
  copy_planes(0);

  // M (8 or 4) held-out genes of the list from b0 (cnt of them real; past
  // the count any gene's: the reduce-scatter keeps entries apart, and those
  // lanes' results go unread), each lane's parts of their dots, the
  // reduce-scatter over offsets 16, 8 (and 4 for M = 8), a lane keeping
  // the half of its entries whose index bit matches its lane bit, then the
  // rest of the butterfly: lane l ends with entry (l >> (5 - log2 M)) &
  // (M - 1); then every error to every lane in entry order, and the cell's
  // sum s in that order. wd, tag: this step's.
  const float* wd = nullptr;
  auto batch = [&](auto mc, int b0, int cnt, float& s) {
    constexpr int M = decltype(mc)::value;
    constexpr int kLog = M == 8 ? 3 : 2;
    const int e_m = (lane >> (5 - kLog)) & (M - 1);
    int g[M];
    if constexpr (M == 8) {
      const int4 ga = reinterpret_cast<const int4*>(list + b0)[0];
      const int4 gc = reinterpret_cast<const int4*>(list + b0)[1];
      g[0] = ga.x; g[1] = ga.y; g[2] = ga.z; g[3] = ga.w;
      g[4] = gc.x; g[5] = gc.y; g[6] = gc.z; g[7] = gc.w;
    } else {
      const int4 ga = reinterpret_cast<const int4*>(list + b0)[0];
      g[0] = ga.x; g[1] = ga.y; g[2] = ga.z; g[3] = ga.w;
    }
    // this lane's entry's value, A(c, g) or 0
    const uint2 at = dense[list[b0 + e_m]];
    const float a_l = at.x == tag ? __uint_as_float(at.y) : 0.f;
    float p[M];
#pragma unroll
    for (int e = 0; e < M; ++e) {
      const float* row = wd + (size_t)g[e] * kp;
      float acc = 0.f;
      if constexpr (NPL == 1) {
        acc = fmaf(h[0][0], row[lane], acc);
      } else if constexpr (NPL == 2) {
        const float2 v = reinterpret_cast<const float2*>(row)[lane];
        acc = fmaf(h[0][0], v.x, acc);
        acc = fmaf(h[0][1], v.y, acc);
      } else {
#pragma unroll
        for (int q = 0; q < NPL / 4; ++q) {
          const float4 v =
              reinterpret_cast<const float4*>(row + 128 * q)[lane];
          acc = fmaf(h[0][4 * q], v.x, acc);
          acc = fmaf(h[0][4 * q + 1], v.y, acc);
          acc = fmaf(h[0][4 * q + 2], v.z, acc);
          acc = fmaf(h[0][4 * q + 3], v.w, acc);
        }
      }
      p[e] = acc;
    }
#pragma unroll
    for (int lvl = 0; lvl < kLog; ++lvl) {
      const int off = 16 >> lvl;
      const int half = M >> (lvl + 1);
      const bool up = (lane & off) != 0;
#pragma unroll
      for (int i = 0; i < half; ++i) {
        const float send = up ? p[i] : p[i + half];
        const float keep = up ? p[i + half] : p[i];
        p[i] = keep + __shfl_xor_sync(kFull, send, off);
      }
    }
    float v = p[0];
#pragma unroll
    for (int off = 16 >> kLog; off >= 1; off >>= 1) {
      v += __shfl_xor_sync(kFull, v, off);
    }
    const float diff = v - a_l;
    __syncwarp();
    if ((lane & ((32 >> kLog) - 1)) == 0) scratch[e_m] = diff;
    __syncwarp();
    float d[M];
#pragma unroll
    for (int e4 = 0; e4 < M; e4 += 4) {
      const float4 dv = reinterpret_cast<const float4*>(scratch)[e4 / 4];
      d[e4] = dv.x;
      d[e4 + 1] = dv.y;
      d[e4 + 2] = dv.z;
      d[e4 + 3] = dv.w;
    }
#pragma unroll
    for (int e = 0; e < M; ++e) {
      if (e < cnt) s = fmaf(d[e], d[e], s);
    }
  };

  for (int t = 0; t < steps; ++t) {
    const int buf = t & 1;
    const int gb = t / a.n_sb;
    const int sb = t - gb * a.n_sb;
    if (sb == 0) {
      // this gene block's copies (issued a gene block ago) have landed;
      // the next one's go into the other buffer
      cp_async_wait_all();
      __syncwarp();
      if (gb + 1 < a.n_gb) copy_planes(gb + 1);
    }
    mbar_wait(&full[buf], (t >> 1) & 1);
    wd = wd_s + (size_t)buf * R * kp;
    const uint32_t* bits = bits_s + (size_t)(gb & 1) * C * a.bm_pitch;
    const int32_t* li = li_s + (size_t)(gb & 1) * plane;
    const float* lv = lv_s + (size_t)(gb & 1) * plane;
    const int g0 = sb * R;   // the sub-block's first local gene
    // the walker's cells in turn, one loop body (the code stays small):
    // the cell's H row is h[0], the rows rotate by one after each cell
#pragma unroll 1
    for (int j = 0; j < CPW; ++j) {
      const int cl = warp * CPW + j;
      // the cell's bits of the sub-block (R / 32 words) and its first 32
      // slots, loaded together
      const uint32_t* cb = bits + (size_t)cl * a.bm_pitch + sb * (R >> 5);
      uint32_t w[4] = {0u, 0u, 0u, 0u};
      const bool live = c0 + cl < a.cells;
      if (live) {
        if (R == 128) {
          const uint4 v = *reinterpret_cast<const uint4*>(cb);
          w[0] = v.x;
          w[1] = v.y;
          w[2] = v.z;
          w[3] = v.w;
        } else if (R == 64) {
          const uint2 v = *reinterpret_cast<const uint2*>(cb);
          w[0] = v.x;
          w[1] = v.y;
        } else {
          w[0] = *cb;
        }
      }
      int ls[3];
      float vs[3];
#pragma unroll
      for (int u = 0; u < 3; ++u) {
        const int slot = min(32 * u + lane, width - 1) * (C + 1) + cl;
        ls[u] = li[slot] - g0;
        vs[u] = lv[slot];
      }
      const int total = __popc(w[0]) + __popc(w[1]) + __popc(w[2]) +
                        __popc(w[3]);
      if (total > 0) {
        ++tag;
        // the held-out genes in ascending order into the walker's list,
        // each lane its bits l, 32 + l, ...: a set bit's place is the
        // count of the set bits below it
        int base = 0;
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          if ((w[q] >> lane) & 1u) {
            list[base + __popc(w[q] & below)] = 32 * q + lane;
          }
          base += __popc(w[q]);
        }
        // the cell's live slots of the sub-block into the tagged row, in
        // slot order
#pragma unroll
        for (int u = 0; u < 3; ++u) {
          if (32 * u + lane < width && ls[u] >= 0 && ls[u] < R) {
            dense[ls[u]] = make_uint2(tag, __float_as_uint(vs[u]));
          }
        }
        for (int u = 96 + lane; u < width; u += 32) {   // width > 96
          const int l = li[u * (C + 1) + cl] - g0;
          if (l >= 0 && l < R) {
            dense[l] = make_uint2(tag, __float_as_uint(lv[u * (C + 1) + cl]));
          }
        }
        __syncwarp();
        // the cell's sum so far, in every lane
        float s = __shfl_sync(kFull, s_mine, j);
        // eight held-out genes at a time, and a last four where at most
        // four are left
        int b0 = 0;
        for (; total - b0 > 4; b0 += kBatch) {
          batch(std::integral_constant<int, kBatch>{}, b0, total - b0, s);
        }
        if (b0 < total) {
          batch(std::integral_constant<int, 4>{}, b0, total - b0, s);
        }
        if (lane == j) {
          s_mine = s;
          n_mine += (float)total;   // counts below 2^24: exact
        }
        __syncwarp();
      }
#pragma unroll
      for (int q = 0; q < NPL; ++q) {
        const float h0 = h[0][q];
#pragma unroll
        for (int u = 0; u + 1 < CPW; ++u) h[u][q] = h[u + 1][q];
        h[CPW - 1][q] = h0;
      }

    }
    __syncwarp();
    if (lane == 0) mbar_arrive(&empty[buf]);
  }

  const long long c = c0 + warp * CPW + lane;
  if (lane < CPW && c < a.cells) {
    a.out[c] = s_mine;
    a.out[a.cells + c] = n_mine;
  }
}

// (NPL, CPW) instantiated: NPL = ceil(k / 32) rounded up to 1, 2, 4, 8,
// 12 or 16; CPW the most cells whose H rows take 32 floats a lane (at
// least 2, at most 16), 8, 4 and 1 (ops/bell_cuda.py `b7_cpws`)
constexpr int kNpls[] = {1, 2, 4, 8, 12, 16};
constexpr int kCpws[] = {16, 8, 4, 2, 1};

__host__ __device__ constexpr int cpw_top(int npl) {
  return npl >= 12 ? 2 : npl == 1 ? 16 : 32 / npl;
}

__host__ __device__ constexpr bool cpw_ok(int npl, int cpw) {
  return cpw <= cpw_top(npl) &&
         (cpw == cpw_top(npl) || cpw == 8 || cpw == 4 || cpw == 1);
}

template <int NPL, int CPW>
cudaError_t launch(const Args& a, size_t smem, int blocks, cudaStream_t s) {
  auto kernel = b7_kernel<NPL, CPW>;
  static bool configured = false;   // per instantiation, on first launch
  if (!configured) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)kSmemMax);
    if (err != cudaSuccess) return err;
    configured = true;
  }
  kernel<<<blocks, (a.walkers + 1) * 32, smem, s>>>(a);
  return cudaGetLastError();
}

template <int NPL, int J = 0>
cudaError_t launch_cpw(const Args& a, int cpw, size_t smem, int blocks,
                       cudaStream_t s) {
  if constexpr (J < (int)(sizeof(kCpws) / sizeof(int))) {
    constexpr int CPW = kCpws[J];
    if (cpw == CPW) {
      if constexpr (cpw_ok(NPL, CPW)) {
        return launch<NPL, CPW>(a, smem, blocks, s);
      }
      return cudaErrorInvalidValue;
    }
    return launch_cpw<NPL, J + 1>(a, cpw, smem, blocks, s);
  }
  return cudaErrorInvalidValue;
}

template <int I = 0>
cudaError_t launch_npl(const Args& a, int npl, int cpw, size_t smem,
                       int blocks, cudaStream_t s) {
  if constexpr (I < (int)(sizeof(kNpls) / sizeof(int))) {
    constexpr int NPL = kNpls[I];
    if (npl == NPL) return launch_cpw<NPL>(a, cpw, smem, blocks, s);
    return launch_npl<I + 1>(a, npl, cpw, smem, blocks, s);
  }
  return cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// Device pointers: li int32 / lv float32 planes, row r at r * ld (ld and
// the planes' addresses as they are; 4-byte copies); words (cells rows of
// stride wld) uint32; wp Wd permuted (n_gb * gene_block, kp), kp = 32 npl,
// 16-byte aligned; H (cells, k) contiguous float32; bm scratch of n_gb *
// cells_pad * bm_pitch words (cells_pad: the cells rounded up to the
// plan's tile of walkers * cpw; bm_pitch: ceil(gene_block / 32) rounded up
// to 8); out (2, cells) float32. npl, cpw, walkers and rows_sb from
// `b7_plan`
// (ops/bell_cuda.py). Returns the cudaError_t of the first failed launch
// (0 on success): the pass, then the kernel.
int bell_mse_bits(const int32_t* li, const float* lv, long long ld, int n_gb,
                  int width, int cells, int gene_block, const uint32_t* words,
                  long long wld, const float* wp, const float* H, int k,
                  int npl, int cpw, int walkers, int rows_sb, uint32_t* bm,
                  int cells_pad, int bm_pitch, float* out, void* stream) {
  if (cells <= 0) return cudaSuccess;
  if (k <= 0 || gene_block <= 0 || n_gb <= 0 || width <= 0 ||
      walkers < 1 || walkers > max_walkers(npl, cpw) ||
      bm_pitch % kBmWords != 0 ||
      bm_pitch * 32 < gene_block ||
      (rows_sb != 32 && rows_sb != 64 && rows_sb != 128) ||
      ((uintptr_t)wp & 15) != 0 || ((uintptr_t)bm & 15) != 0) {
    return cudaErrorInvalidValue;
  }
  const int C = walkers * cpw;
  if (!cpw_ok(npl, cpw) || cells_pad % C != 0 || cells_pad < cells ||
      32 * npl < k) {
    return cudaErrorInvalidValue;
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int n_t = (n_gb + 31) / 32;
  const long long pass_blocks = (long long)((cells_pad + kBmCells - 1) /
                                            kBmCells) * n_t *
                                (bm_pitch / kBmWords);
  b7_bits_kernel<<<(unsigned)pass_blocks, 256, 0, s>>>(
      words, wld, cells, cells_pad, n_gb, gene_block, bm_pitch, bm);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;

  Args a{};
  a.li = li;
  a.lv = lv;
  a.ld = ld;
  a.n_gb = n_gb;
  a.width = width;
  a.cells = cells;
  a.gene_block = gene_block;
  a.bm = bm;
  a.cells_pad = cells_pad;
  a.bm_pitch = bm_pitch;
  a.wp = wp;
  a.H = H;
  a.k = k;
  a.kp = 32 * npl;
  a.out = out;
  a.walkers = walkers;
  a.rows_sb = rows_sb;
  a.n_sb = (gene_block + rows_sb - 1) / rows_sb;
  const size_t smem =
      b7_layout(rows_sb, a.kp, C, bm_pitch, walkers, width).total;
  if (smem > kSmemMax) return cudaErrorInvalidValue;
  return launch_npl(a, npl, cpw, smem, cells_pad / C, s);
}

const char* bell_mse_bits_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"

// Blocked-ELL SpMM in both directions: kernels B3 and B4 of the port, and
// with the keep factor read from bitplane words B5 and B6, for sm_90a.
//
// B3 (`bell_spmm`) replaces singlet_tpu/ops/pallas_bell.py `bell_spmm`
// (kernel body `_spmm_kernel`), B4 (`bell_spmm_t`) replaces `bell_spmm_t`
// (`_spmm_t_kernel`); the same entry points with keep mode 2 are B5
// (`bell_spmm_bits`, `_spmm_bits_kernel`) and B6 (`bell_spmm_t_bits`,
// `_spmm_t_bits_kernel`). On planes (n_gb * width, cells) of LOCAL gene ids li
// (pad -1) and values lv (pad 0), cells contiguous with row stride `ld`:
//
//   B3:  B[c, :]  = sum over live slots (gb, w) of cell c of
//                   lv * keep * W[gb * GB + li, :]                 (cells, k)
//   B4:  Bw[g, :] = sum over the cells c with a live slot at gene g of
//                   lv * keep * H[c, :]                      (n_gb * GB, k)
//
// keep is 1 (`masked` 0); or 1 - testmask(seed, cell_offset + c, g)
// (`masked` 1): the counter hash of singlet_tpu_torch/ops/rngmask.py
// `mask_block`, bit for bit (rand(i) per cell, then the j-mix, the 64-bit
// add, the final xorshifts and `x % inv_density == 0`), on native uint64;
// or (`masked` 2, B5 and B6) 1 - the test bit of (c, g) in the packed words
// of singlet_tpu_torch/ops/maskbits.py, words[c, (gb >> 5) * GB + li] >>
// (gb & 31) & 1, in place of the hash (B6 loads a word per slot; B5 reads
// the bit from its first kernel's transpose of the words).
// Pad slots are skipped: the TPU kernel multiplies them out, hashing a
// bogus gene id. The three modes differ only in which slots are skipped,
// so B5 gives the bits of B3 with the hash, and B6 those of B4, whenever
// the words hold the same mask.
//
// Design, and what bounds it. The TPU densifies each (gene block, 256
// cells) tile by a one-hot multiply-compare-sum because it has no gather,
// and then runs the dense product on the matrix unit. Hopper gathers, so
// both kernels touch only the nonzeros: at 524,288 cells x 16,384 genes,
// k = 100, 5% dense, that is 420M nonzeros x k = 84 GFLOP against 1.7 TFLOP
// for the densified tiles. Neither is bound by device-memory bytes (the
// planes, 4.3 GB, are read once by B3 and once per row group by B4); the
// bound is the number of gathered rows moved through L1/L2 and shared
// memory per nonzero, k floats each.
//
// B3 (and B5, its mode 2): W's rows come from shared memory, one gene
// block at a time. A block owns a cell tile of C = 64, 128 or 256 cells and
// a column tile of kt <= 32 columns (a multiple of 4); the blocks of a
// cell tile's column tiles are neighbours in the grid, so its planes come
// from L2 after the first read, and pairs of them form a cluster. The block
// walks the gene blocks in order (planes wider than shared memory holds
// in windows of slot rows, one after the other). Per step, 4 stager warps
// prepare the next step while 16 walker warps walk this one: one stager
// asks TMA for W's (gene_block, kt) slice of the next gene block (into the
// buffer of its parity; the box zero-fills past k); the stagers keep-test
// this block's share of the next step's window (half the slot rows in a
// cluster of two), once for the cluster (the hash, its `%` a multiply by a
// modular inverse, or the test bit), from ids and values that TMA brought
// as soon as the last share was read, and write per slot its W row's
// offset in the slice and its value, a pad or held-out slot pointing at a
// zero row with the value -0, whose fmaf leaves every sum as it is; a bulk
// copy takes the share to the other block of the cluster, counted on its
// mbarrier. The walkers take a quarter-warp per cell (lane q holds columns
// 4q .. 4q + 3): per slot one 8-byte (offset, value) load shared by the
// quarter and one 16-byte load of W's row from shared memory, four fmaf,
// no branch, so several slots' loads are in flight. Every output is one
// lane's fmaf chain over its cell's gene blocks in order and, in each, its
// slots in slot order: the bits of the one-warp-per-cell kernel this
// design replaces, and B5's are masked B3's. One launch for any k.
// B5 first runs a small kernel that transposes its cells' words into test
// bits by gene block, bm[gb][l >> 5][c] (bell_words_t_kernel): a word load
// per slot goes through the L1 data path the walk uses and slowed the
// walkers by about 65%; instead the stagers' TMA brings a gene block's
// bits of the tile's cells (ceil(GB / 32) words a cell) with the ids, and
// a slot's test is a bit in shared memory.
// What bounds it: the walk's shared-memory wavefronts, one 128-byte
// wavefront per quarter-warp and slot, pads included, and one per warp for
// the pairs (5 per 4 cells and slot at kt <= 32); then L2, which brings
// W's slice once per cell tile and gene block (|W| / C a cell), the planes
// once per cluster and B5's test bits once per column tile. Budget per
// block (640 threads, one block an SM, clusters of two): at most 96
// registers a thread and no spills (ptxas -v); at k = 100, 128 cells and
// 32 slot rows, 196,904 bytes of shared memory (2 x 57 KB of W, 2 x 32 KB
// of windows, 2 x 8 KB of ids and values, 5 mbarriers), 8 KB more of test
// bits in B5.
//
// B4 (and B6, its mode 2): the scatter direction, deterministic without
// float atomics. A block of 20 warps owns (gene block gb, a row group of
// `rows` of its genes, a column tile of at most 128 of k, a chunk of cells)
// and holds the row group's outputs in registers: lane l keeps VEC = 1, 2
// or 4 adjacent columns (column tiles of 32, 64 or 128), warp w the rows w,
// w + 20, ...: 26 of them at VEC 1 or 2, 13 at VEC 4, so rows = 520 or 260
// (256 at k = 100: two row groups of a gene block of 512). The block walks
// its cells in tiles of 64. Bucketing: each thread takes one cell of the
// tile and its slots w0, w0 + 10, ... (the first 32 slot rows from a window
// that cp.async staged in shared memory); a slot whose gene lies in the row
// group and passes the keep test (the hash, its `%` done as a multiply by a
// modular inverse, or the word; once per entry and column tile) sets the
// (row, cell) bit of a bitmap with an integer atomicOr and leaves its value
// at (row, cell) of a dense (rows, 64) tile in shared memory. A bit found
// already set marks a gene held twice by one cell (non-canonical input):
// that cell's thread then sums its values in slot order. After one barrier
// each warp walks the set bits of its rows in cell order and adds v *
// H[cell, j0 + VEC * lane + :VEC] (one vector load from the H tile in
// shared memory) into its registers. The next tile's H rows and window load
// with cp.async, double-buffered, while this one is summed. A row's run is
// its set bits, in cell order by construction: the bitmap needs no counting
// sort, no scan and no second pass over the slots, at the price of the
// dense value tile (64 KB at 256 rows). Every output is one lane's sum over
// its live cells in cell order. The planes are read once per row group
// (twice at gene_block 512, k = 100) and keep-tested once per column tile
// (once for k <= 128); H once per gene block and row group, from L2.
// Chunks of cells give about one block per SM (132 on an H100): each
// chunk's partial tile goes to scratch, and the block that completes an
// output tile last (an integer counter) sums the chunks' tiles in chunk
// order, so the result is the same bits on every run. The accumulators
// leave through shared memory, so the epilogue's 64-bit addressing never
// competes with them for registers.
// What bounds it: the walk waits on its shared-memory loads (a row's bits,
// then per live entry its value and its H row: 5 wavefronts for 4 FMAs a
// lane at VEC 4), so it wants as many warps as the accumulators' registers
// allow. 20 warps of 96 registers is the most that ptxas compiles without
// spills (32 warps of 64 registers spill a few). Its device-memory bytes
// take 0.02 ms and its FMAs 0.02 ms at the f32 peak on the 8192-cell slice
// at k = 100 (PERF.md holds its times).
// Budget per block (640 threads, one block an SM): at most 96 registers a
// thread and no spills (ptxas -v, every instantiation); at k = 100 (256
// rows), 138,256 bytes of shared memory (16 KB of window, 64 KB of values,
// 4 KB of bits, 2 x 26 KB of H).
//
// Arithmetic is float32 (fused multiply-adds); build without
// --use_fast_math. Only the order of the sums differs from the plain
// PyTorch versions.

// B3 and B5 on gene blocks wider than shared memory holds (the wide-block
// route, `bell_spmm_wide`): where two buffers of a gene block's slice of W
// do not fit beside the windows (gene blocks past 7,168 genes for B3 and
// 5,632 for B5 at k = 100; ops/bell_cuda.py `b3_plan` takes this route
// there), W's rows come from device memory (L2 holds W: 3.3 MB at 16,384
// genes and k = 50). What bounds it is L2: every kept slot brings W's row
// once, k floats in whole 32-byte sectors (about 0.74 GB at 4,096 cells,
// 16,384 genes, 800 slots a cell and k = 50), and B5 also the slots' test
// words from device memory, one random sector a slot. The one-warp-per-
// cell kernel this design replaced (csrc/bell_spmm_wide_warp.cu) walked a
// cell's kept slots one after the other, so each W row's trip to L2 waited
// on the last one; here a lane has 16 of them in flight:
// - L = 4, 8, 16 or 32 lanes a cell, the fewest whose loads of VW = 4
//   adjacent columns (for B5 2 where k is 2 mod 4: no padded copy of W,
//   and twice the warps to hide the test words) cover k, or 32 loads of
//   it, two loads a lane past that; a warp holds 32 / L cells and few
//   lanes idle (k = 50: 13 of 16, or 25 of 32), a block of 8 warps 256 / L
//   cells;
// - the block stages each window of 32 slot rows of its cells (loads of
//   the planes with neighbouring threads on neighbouring cells) and
//   keep-tests it once, into shared memory as (W row, value) pairs, a
//   skipped slot as row -1; the ids of the window after next and the test
//   words of the next one are in flight meanwhile, so the words'
//   device-memory latency is paid behind a walk;
// - a lane reads 16 pairs of its cell (8 at two loads a lane), issues
//   their loads of W's rows, then adds them in slot order.
// Every output is one lane's fmaf chain over its cell's gene blocks in
// order and, in each, its kept slots in slot order: the bits of the tiled
// kernel (whose skipped slots add -0 times a zero row, which leaves a sum
// as it is), and B5's are masked B3's. W's address and row stride are
// multiples of VW floats (the wrapper pads a copy where they are not).
// On an H100 (700 W) at 4,096 cells and gene blocks of 8,192 this moves
// 6-7 TB/s of W's sectors from L2 (PERF.md); B5's random test words cost
// about 0.08 ms more at k = 50, which the walk does not hide.

#include <cuda.h>  // CUtensorMap and its enums; the encoder comes from the runtime
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWalkWarps = 16;                  // B3: warps that walk
constexpr int kStageWarps = 4;                  // B3: warps that stage
constexpr int kStageThreads = kStageWarps * 32;
constexpr int kThreads3 = kWalkWarps * 32 + kStageThreads;
constexpr int kLanesCell = 8;                   // B3: lanes a cell, 4 columns each
constexpr int kCellsPass = kWalkWarps * 32 / kLanesCell;  // B3: cells walked at once
constexpr int kMaxRounds = 4;                   // B3: passes of 64 cells a block
constexpr int kColTile3 = 4 * kLanesCell;       // B3: output columns a block
constexpr int kBatch = 8;                       // B3: slots a stager tests at once
constexpr int kWarpsT = 20;                     // B4: warps per block
constexpr int kThreadsT = kWarpsT * 32;
constexpr int kTile = 64;                       // B4: cells per tile
constexpr int kTileWords = kTile / 32;          // B4: bit words per row
constexpr int kWinRows = 32;                    // B4: slot rows staged a tile
constexpr int kColTile = 128;                   // B4: output columns a block
constexpr long long kMaxSmem = 232448;          // a Hopper block's shared memory

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

// ---- B4 and B6 --------------------------------------------------------------

// Arguments of one B4/B6 launch; the host plan (rows, chunk_tiles,
// n_chunks) comes from the shapes alone (ops/bell_cuda.py `b4_plan`).
struct B4Args {
  const int32_t* li;
  const float* lv;
  long long ld;
  int n_gb, width, cells, gene_block;
  const float* H;
  int k;
  float* out;          // Bw (n_gb * gene_block, k)
  float* partials;     // (n_chunks, n_gb * gene_block, k) if n_chunks > 1
  int* counters;       // one per output tile if n_chunks > 1
  int rows;            // gene rows of a block (one row group)
  int chunk_tiles;     // tiles of a cell chunk
  int n_chunks;
  int h_vec;           // floats per cp.async of H: 4, 2 or 1
  int p_vec;           // cells per cp.async of the planes: 4 or 1
  int masked;
  uint64_t seed;
  long long cell_offset;
  // x % inv_density == 0 as a multiply (Granlund and Montgomery): with
  // inv_density = odd << shift, x is a multiple iff its low `shift` bits
  // are 0 and x * odd^-1 mod 2^64 <= (2^64 - 1) / odd
  int shift;
  uint64_t odd_inverse;
  uint64_t odd_limit;
  const uint32_t* words;
  long long wld;
};

__host__ __device__ inline int b4_cols(int k) {
  return k < kColTile ? k : kColTile;
}

// adjacent output columns per lane: 1, 2 or 4, for a column tile of at
// most 32, 64 or 128
__host__ __device__ inline int b4_vec(int k) {
  return b4_cols(k) <= 32 ? 1 : b4_cols(k) <= 64 ? 2 : 4;
}

// gene rows a warp holds: 26 for 1 or 2 columns a lane, 13 for 4 (at most
// 52 accumulators a lane), so a block holds 520 or 260 rows
__host__ __device__ constexpr int b4_genes(int vec) {
  return vec == 4 ? 13 : 26;
}

// floats of a staged H row: the tile's columns rounded up to 16 bytes
__host__ __device__ inline int b4_hstride(int k) {
  return (b4_cols(k) + 3) / 4 * 4;
}

// floats of one H buffer: the tile's rows, and room for the last row's
// lanes to read past its columns (sums that are never stored)
__host__ __device__ inline int b4_hfloats(int k) {
  return kTile * b4_hstride(k) + 32 * b4_vec(k);
}

// dynamic shared memory of a block (ops/bell_cuda.py `b4_smem` is the same)
__host__ __device__ inline long long b4_smem_bytes(int rows, int k) {
  return (long long)kWinRows * kTile * 8         // slot window
         + (long long)rows * kTile * 4           // values by (row, cell)
         + 2LL * rows * kTileWords * 4           // live bits, x2
         + 2LL * b4_hfloats(k) * 4               // H tiles, double-buffered
         + 16;                                   // flags
}

__device__ __forceinline__ void cp_async_4(void* dst, const void* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d),
               "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async_8(void* dst, const void* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(d),
               "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async_16(void* dst, const void* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d),
               "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// Start the copies of tile t into shared memory, as one cp.async group: H's
// rows, columns [j0, j0 + kt), into `hd` (row stride hs), and the first
// kWinRows slot rows of gene block gb's window into `wl`/`wv` (row stride
// kTile).
__device__ __forceinline__ void b4_load_tile(const B4Args& a, int t, int gb,
                                             int j0, int kt, int hs,
                                             float* hd, int* wl, float* wv) {
  const int tid = threadIdx.x;
  const int prow = gb * a.width;  // gb's first plane row
  const int wr = min(a.width, kWinRows);
  const int cb = t * kTile;
  const int nc = min(kTile, a.cells - cb);
  // H: a thread copies piece tid % (128 / h_vec) of rows tid / (128 /
  // h_vec), + 640 / (128 / h_vec), ...
  const float* src = a.H + (long long)cb * a.k + j0;
  if (a.h_vec == 4) {
    const int q = (tid & 31) << 2;
    for (int r = tid >> 5; q < kt && r < nc; r += kThreadsT >> 5) {
      cp_async_16(hd + r * hs + q, src + r * a.k + q);
    }
  } else if (a.h_vec == 2) {
    const int q = (tid & 63) << 1;
    for (int r = tid >> 6; q < kt && r < nc; r += kThreadsT >> 6) {
      cp_async_8(hd + r * hs + q, src + r * a.k + q);
    }
  } else {
    const int q = tid & 127;
    for (int r = tid >> 7; q < kt && r < nc; r += kThreadsT >> 7) {
      cp_async_4(hd + r * hs + q, src + r * a.k + q);
    }
  }
  // the window: 16-byte pieces of each slot row where the planes allow,
  // cell by cell in the ragged last tile
  if (a.p_vec == 4) {
    for (int i = tid; i < wr * (kTile / 4); i += kThreadsT) {
      const int w = i / (kTile / 4), q = (i % (kTile / 4)) * 4;
      const long long off = (long long)(prow + w) * a.ld + cb + q;
      if (q + 4 <= nc) {
        cp_async_16(wl + w * kTile + q, a.li + off);
        cp_async_16(wv + w * kTile + q, a.lv + off);
      } else {
        for (int e = 0; e < nc - q; ++e) {
          cp_async_4(wl + w * kTile + q + e, a.li + off + e);
          cp_async_4(wv + w * kTile + q + e, a.lv + off + e);
        }
      }
    }
  } else {
    for (int i = tid; i < wr * kTile; i += kThreadsT) {
      const int w = i / kTile, q = i % kTile;
      if (q < nc) {
        const long long off = (long long)(prow + w) * a.ld + cb + q;
        cp_async_4(wl + w * kTile + q, a.li + off);
        cp_async_4(wv + w * kTile + q, a.lv + off);
      }
    }
  }
  cp_async_commit();
}

// whether slot (cell, gene gb * gene_block + l) is kept in keep mode MODE:
// `xi` is the cell's hash (mode 1), `word` its packed test-mask word of l
// (mode 2); `a` is a B3Args or a B4Args
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

// acc[:] += v * h[:VEC], h VEC adjacent floats of a staged H row
__device__ __forceinline__ void b4_fma(float (&acc)[1], float v,
                                       const float* h) {
  acc[0] = fmaf(v, h[0], acc[0]);
}
__device__ __forceinline__ void b4_fma(float (&acc)[2], float v,
                                       const float* h) {
  const float2 x = *reinterpret_cast<const float2*>(h);
  acc[0] = fmaf(v, x.x, acc[0]);
  acc[1] = fmaf(v, x.y, acc[1]);
}
__device__ __forceinline__ void b4_fma(float (&acc)[4], float v,
                                       const float* h) {
  const float4 x = *reinterpret_cast<const float4*>(h);
  acc[0] = fmaf(v, x.x, acc[0]);
  acc[1] = fmaf(v, x.y, acc[1]);
  acc[2] = fmaf(v, x.z, acc[2]);
  acc[3] = fmaf(v, x.w, acc[3]);
}

// VEC adjacent output columns per lane; keep mode MODE (0, 1 or 2)
template <int VEC, int MODE>
__global__ void __launch_bounds__(kThreadsT, 1)
bell_spmm_t_kernel(const B4Args a) {
  constexpr int kGenes = b4_genes(VEC);    // gene rows a warp
  extern __shared__ __align__(16) float smem_t[];
  const int hs = b4_hstride(a.k);
  const int hfl = b4_hfloats(a.k);
  const int set_words = a.rows * kTileWords;
  // the window and the values first, at fixed offsets (no registers for
  // their addresses), then the bits, the H tiles and the flags
  int* s_wl = reinterpret_cast<int*>(smem_t);              // (32, 64)
  float* s_wv = smem_t + kWinRows * kTile;                 // (32, 64)
  float* s_val = smem_t + 2 * kWinRows * kTile;            // (rows, 64)
  uint32_t* s_bits = reinterpret_cast<uint32_t*>(s_val + a.rows * kTile);
  float* s_h = reinterpret_cast<float*>(s_bits + 2 * set_words);  // 2 x hfl
  int* s_flag = reinterpret_cast<int*>(s_h + 2 * hfl);

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int n_rg = (a.gene_block + a.rows - 1) / a.rows;
  const int gb = blockIdx.x / n_rg;
  const int r0 = (blockIdx.x - gb * n_rg) * a.rows;
  const int rows = min(a.rows, a.gene_block - r0);
  const int j0 = blockIdx.y * kColTile;
  const int kt = min(kColTile, a.k - j0);
  const int n_tiles = (a.cells + kTile - 1) / kTile;
  const int t_begin = blockIdx.z * a.chunk_tiles;
  const int t_end = min(n_tiles, t_begin + a.chunk_tiles);
  // bucketing: thread tid takes cell c of every tile, its slots w0, w0 +
  // 10, ...; slot rows below kWinRows come from the staged window
  const int c = tid % kTile;
  const int w0 = tid / kTile;
  constexpr int kStep = kThreadsT / kTile;

  float acc[kGenes][VEC];
#pragma unroll
  for (int g = 0; g < kGenes; ++g) {
#pragma unroll
    for (int s = 0; s < VEC; ++s) acc[g][s] = 0.f;
  }

  for (int i = tid; i < 2 * set_words; i += kThreadsT) s_bits[i] = 0u;
  if (tid < 2) s_flag[tid] = 0;
  if (t_begin < t_end) {
    b4_load_tile(a, t_begin, gb, j0, kt, hs, s_h + (t_begin & 1) * hfl, s_wl,
                 s_wv);
  }
  cp_async_wait_all();
  __syncthreads();

  for (int t = t_begin; t < t_end; ++t) {
    const int p = t & 1;
    uint32_t* bits = s_bits + p * set_words;
    const int cell = t * kTile + c;
    // bucket: each kept slot of the row group sets its (row, cell) bit and
    // leaves its value at (row, cell); the hash or word test runs once
    if (cell < a.cells) {
      const uint64_t xi =
          MODE == 1 ? cell_hash(a.seed, a.cell_offset + cell) : 0;
      const uint32_t* wrow =
          MODE == 2 ? a.words + (long long)cell * a.wld +
                          (gb >> 5) * a.gene_block
                    : nullptr;
      bool dup = false;
      for (int w = w0; w < a.width; w += kStep) {
        int l;
        float v;
        if (w < kWinRows) {
          l = s_wl[w * kTile + c];
          v = s_wv[w * kTile + c];
        } else {
          const long long off = (long long)(gb * a.width + w) * a.ld + cell;
          l = __ldg(a.li + off);
          v = __ldg(a.lv + off);
        }
        const int r = l - r0;
        if ((unsigned)r < (unsigned)rows &&
            slot_kept<MODE>(a, gb, xi, l, MODE == 2 ? __ldg(wrow + l) : 0u)) {
          s_val[r * kTile + c] = v;
          const uint32_t bit = 1u << (c & 31);
          dup |= (atomicOr(bits + r * kTileWords + (c >> 5), bit) & bit) != 0u;
        }
      }
      if (dup) s_flag[p] = 1;
    }
    __syncthreads();

    if (s_flag[p]) {
      // one cell holds a gene in two slots (non-canonical input): that
      // cell's thread of slot 0 sums the values in slot order, as the
      // plain version's dense tile does
      if (w0 == 0 && cell < a.cells) {
        const uint64_t xi =
            MODE == 1 ? cell_hash(a.seed, a.cell_offset + cell) : 0;
        const uint32_t* wrow =
            MODE == 2 ? a.words + (long long)cell * a.wld +
                            (gb >> 5) * a.gene_block
                      : nullptr;
        for (int pass = 0; pass < 2; ++pass) {
          for (int w = 0; w < a.width; ++w) {
            const long long off = (long long)(gb * a.width + w) * a.ld + cell;
            const int l = __ldg(a.li + off);
            const int r = l - r0;
            if ((unsigned)r >= (unsigned)rows) continue;
            const uint32_t word = MODE == 2 ? __ldg(wrow + l) : 0u;
            if (!slot_kept<MODE>(a, gb, xi, l, word)) continue;
            float* slot = s_val + r * kTile + c;
            *slot = pass == 0 ? 0.f : *slot + __ldg(a.lv + off);
          }
        }
      }
      __syncthreads();
    }

    // the next tile's H rows and window (read only by the bucketing, now
    // done) are in flight while this one is summed; the other parity's
    // bits and flag are cleared for it
    if (t + 1 < t_end) {
      b4_load_tile(a, t + 1, gb, j0, kt, hs, s_h + (p ^ 1) * hfl, s_wl,
                   s_wv);
    }
    for (int i = tid; i < set_words; i += kThreadsT) {
      s_bits[(p ^ 1) * set_words + i] = 0u;
    }
    if (tid == 0) s_flag[p ^ 1] = 0;

    // sum: warp `warp` owns rows warp, warp + 20, ...; for each, its live
    // cells in order, v * H[cell, j0 + VEC * lane + :VEC] from shared
    // memory into registers
    const float* hb = s_h + p * hfl + VEC * lane;
#pragma unroll
    for (int g = 0; g < kGenes; ++g) {
      const int r = g * kWarpsT + warp;
      if (r < rows) {
        const float* vrow = s_val + r * kTile;
        const uint2 w = *reinterpret_cast<const uint2*>(bits + r * 2);
#pragma unroll
        for (int q = 0; q < kTileWords; ++q) {
          uint32_t live = q == 0 ? w.x : w.y;
          while (live) {
            const int cc = (q << 5) + __ffs(live) - 1;
            live &= live - 1;
            b4_fma(acc[g], vrow[cc], hb + cc * hs);
          }
        }
      }
    }
    // the values and bits are consumed, and the next tile has landed
    cp_async_wait_all();
    __syncthreads();
  }

  // epilogue: the accumulators go through shared memory (row stride hs;
  // every tile and copy is done), then the block writes Bw directly, or
  // this chunk's partial tile, and the block that completes an output tile
  // last sums the chunks' tiles in chunk order
  float* e = smem_t;
#pragma unroll
  for (int g = 0; g < kGenes; ++g) {
    const int r = g * kWarpsT + warp;
    if (r < rows && VEC * lane < hs) {
#pragma unroll
      for (int s = 0; s < VEC; ++s) e[r * hs + VEC * lane + s] = acc[g][s];
    }
  }
  __syncthreads();
  const long long row0 = (long long)gb * a.gene_block + r0;
  float* out = a.n_chunks == 1 ? a.out : a.partials + blockIdx.z * (
      (long long)a.n_gb * a.gene_block * a.k);
  for (int r = warp; r < rows; r += kWarpsT) {
    for (int j = lane; j < kt; j += 32) {
      out[(row0 + r) * a.k + j0 + j] = e[r * hs + j];
    }
  }
  if (a.n_chunks == 1) return;
  __threadfence();
  __syncthreads();
  if (tid == 0) {
    const int done = atomicAdd(a.counters + blockIdx.y * gridDim.x + blockIdx.x,
                               1);
    s_flag[2] = done == a.n_chunks - 1;
  }
  __syncthreads();
  if (!s_flag[2]) return;
  __threadfence();
  const long long size = (long long)a.n_gb * a.gene_block * a.k;
  for (int r = warp; r < rows; r += kWarpsT) {
    for (int j = lane; j < kt; j += 32) {
      const long long i = (row0 + r) * a.k + j0 + j;
      float sum = 0.f;
      for (int ch = 0; ch < a.n_chunks; ++ch) {
        const float part = ch == (int)blockIdx.z
                               ? e[r * hs + j]
                               : __ldcg(a.partials + ch * size + i);
        sum = ch == 0 ? part : sum + part;
      }
      a.out[i] = sum;
    }
  }
}

// ---- B3 and B5 --------------------------------------------------------------

// Arguments of one B3/B5 launch; the host plan (kt, rounds, win, cs) comes
// from the shapes alone (ops/bell_cuda.py `b3_plan`).
struct B3Args {
  int n_gb, width, cells, gene_block, k;
  float* B;            // (cells, k)
  int kt;              // columns a column tile: a multiple of 4, <= 32
  int n_kt;            // column tiles
  int rounds;          // passes of 64 cells: a block holds 64 * rounds cells
  int win;             // slot rows a window: width, or fewer if it is wider
  int cs;              // blocks of a cluster: neighbouring column tiles
  int box_rows;        // gene rows a TMA box of W: min(gene_block, 256)
  int masked;
  uint64_t seed;
  long long cell_offset;
  int shift;           // x % inv_density == 0 as a multiply, as in B4Args
  uint64_t odd_inverse;
  uint64_t odd_limit;
  int bm_words;        // keep mode 2: words of a cell's test bits a gene
                       // block, 0 otherwise
};

// keep mode 2's test bits by gene block: words[c, (gb >> 5) * GB + l] bit
// (gb & 31) becomes bit (l & 31) of bm[gb][l >> 5][c] (cells at a row
// stride of `bm_ld`, a multiple of 4, for TMA). A block takes 32 cells and
// 256 genes of one word group: its warps load the cells' words into
// shared memory along the rows, then thread (warp jj, lane c) transposes
// cell c's 32 words of genes 32 jj .. 32 jj + 31 in registers (five block
// swaps) and stores them, neighbouring threads on neighbouring cells.
constexpr int kBmCells = 32;
constexpr int kBmWords = 8;   // 32-gene words a block, one per warp

__global__ void __launch_bounds__(256)
bell_words_t_kernel(const uint32_t* __restrict__ words, long long wld,
                    int cells, int n_gb, int gene_block, int bm_words,
                    long long bm_ld, uint32_t* __restrict__ bm) {
  __shared__ uint32_t tile[kBmCells][32 * kBmWords + 1];
  const int n_t = (n_gb + 31) / 32;
  const int n_jb = (bm_words + kBmWords - 1) / kBmWords;
  const int jb = (int)(blockIdx.x % n_jb);
  const int t = (int)(blockIdx.x / n_jb % n_t);
  const long long c0 = (long long)(blockIdx.x / n_jb / n_t) * kBmCells;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  for (int r = warp; r < kBmCells; r += 8) {
    const long long c = c0 + r;
    for (int x = lane; x < 32 * kBmWords; x += 32) {
      const int l = 32 * kBmWords * jb + x;
      tile[r][x] = c < cells && l < gene_block
                       ? __ldg(words + c * wld + (long long)t * gene_block + l)
                       : 0u;
    }
  }
  __syncthreads();
  const int j = kBmWords * jb + warp;
  const long long c = c0 + lane;
  if (j >= bm_words || c >= cells) return;
  uint32_t m[32];   // m[r] bit b: gene 32 j + r, gene block 32 t + b
#pragma unroll
  for (int r = 0; r < 32; ++r) m[r] = tile[lane][32 * warp + r];
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
#pragma unroll
  for (int b = 0; b < 32; ++b) {
    const int gb = 32 * t + b;
    if (gb < n_gb) bm[((long long)gb * bm_words + j) * bm_ld + c] = m[b];
  }
}

// floats of one buffer of W's slice: whole TMA boxes of gene rows, a zero
// row, room for the last lanes' reads past it, 128-byte aligned
__host__ __device__ inline int b3_w_floats(int gene_block, int kt) {
  const int box = gene_block < 256 ? gene_block : 256;
  const int rows = (gene_block + box - 1) / box * box;
  return (rows * kt + 32 + 31) / 32 * 32;
}

// words of a cell's test bits of one gene block (ops/bell_cuda.py
// `b3_bm_words` is the same)
__host__ __device__ inline int b3_bm_words(int gene_block) {
  return (gene_block + 31) / 32;
}

// slot rows a block stages: its share of a window of win rows
__host__ __device__ inline int b3_share(int win, int cs) {
  return (win + cs - 1) / cs;
}

// dynamic shared memory of a block (ops/bell_cuda.py `b3_smem` is the
// same): two buffers of W's slice (b3_w_floats), two of the cells' (win,
// 64 * rounds) slot window of (offset, value) pairs, the ids and the
// values of the block's share of a window (each 128-byte aligned), in
// keep mode 2 the cells' test bits of a gene block (bm_words a cell), and
// five mbarriers
__host__ __device__ inline long long b3_smem_bytes(int gene_block, int win,
                                                   int kt, int rounds, int cs,
                                                   int bm_words) {
  const long long c = (long long)kCellsPass * rounds;
  const long long raw = (b3_share(win, cs) * c + 31) / 32 * 32;
  return 2LL * b3_w_floats(gene_block, kt) * 4 + 2 * win * c * 8 +
         2 * raw * 4 + c * bm_words * 4 + 40;
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ uint32_t cluster_rank() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;\n" : "=r"(r));
  return r;
}

// every thread of every block of the cluster; release and acquire, so
// stores to other blocks' shared memory before it are seen after it
__device__ __forceinline__ void cluster_sync() {
  asm volatile(
      "barrier.cluster.arrive.release.aligned;\n"
      "barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

// the stagers' own barrier (named barrier 1; the walkers never wait on it)
__device__ __forceinline__ void stagers_sync() {
  asm volatile("bar.sync 1, %0;\n" ::"n"(kStageThreads) : "memory");
}

// the address in the cluster's shared memory of shared address `local` of
// the cluster's block `rank`
__device__ __forceinline__ uint32_t cluster_addr(uint32_t local,
                                                 uint32_t rank) {
  uint32_t remote;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n"
               : "=r"(remote) : "r"(local), "r"(rank));
  return remote;
}

// copy `bytes` (a multiple of 16) of this block's shared memory at `src`
// to `dst` in another block of the cluster, counted on that block's
// mbarrier `bar` (both cluster addresses)
__device__ __forceinline__ void bulk_to_cluster(uint32_t dst, uint32_t src,
                                                uint32_t bytes,
                                                uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.shared::cta.mbarrier::complete_tx::bytes"
      " [%0], [%1], %2, [%3];\n" ::"r"(dst), "r"(src), "r"(bytes), "r"(bar)
      : "memory");
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

// TMA boxes of `map` at the given coordinates (innermost first) into
// shared memory, counted on `bar`
__device__ __forceinline__ void tma_load_2d(void* dst, const CUtensorMap* map,
                                            uint64_t* bar, int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::"
      "bytes [%0], [%1, {%3, %4}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0), "r"(c1)
      : "memory");
}

__device__ __forceinline__ void tma_load_3d(void* dst, const CUtensorMap* map,
                                            uint64_t* bar, int c0, int c1,
                                            int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::"
      "bytes [%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0),
      "r"(c1), "r"(c2)
      : "memory");
}

// keep mode MODE (0, 1 or 2); block b owns column tile b % n_kt and cells
// [(b / n_kt) * C, + C), C = 64 * rounds; the cluster's cs blocks are
// neighbouring column tiles of one cell tile. tm_w views W as (k, gene
// rows, gene blocks) with boxes (kt, box_rows, 1); tm_li and tm_lv view
// the planes as (cells, slot rows) with boxes (C, a block's share of a
// window); in keep mode 2, tm_bm views the test bits as (cells, bm_words,
// gene blocks) with boxes (C, bm_words, 1).
template <int MODE>
__global__ void __launch_bounds__(kThreads3, 1)
bell_spmm_kernel(const B3Args a, const __grid_constant__ CUtensorMap tm_w,
                 const __grid_constant__ CUtensorMap tm_li,
                 const __grid_constant__ CUtensorMap tm_lv,
                 const __grid_constant__ CUtensorMap tm_bm) {
  extern __shared__ __align__(128) float smem3[];
  const int C = kCellsPass * a.rounds;
  const int w_floats = b3_w_floats(a.gene_block, a.kt);
  const int pieces = (a.gene_block + a.box_rows - 1) / a.box_rows;
  const int zero = pieces * a.box_rows * a.kt;   // the zero row
  const int share = b3_share(a.win, a.cs);
  const int raw = (share * C + 31) / 32 * 32;
  // two buffers of W's slice (by gene block parity), two windows of
  // (offset, value) pairs (by step parity), the staged ids and values and
  // test bits; then the mbarriers of the W, the id and the window buffers
  int2* s_win = reinterpret_cast<int2*>(smem3 + 2 * w_floats);
  int* s_li = reinterpret_cast<int*>(s_win + 2 * a.win * C);
  float* s_lv = reinterpret_cast<float*>(s_li + raw);
  const uint32_t* s_bm = reinterpret_cast<const uint32_t*>(s_lv + raw);
  uint64_t* bar_w = reinterpret_cast<uint64_t*>(
      s_lv + raw + (MODE == 2 ? C * a.bm_words : 0));
  uint64_t* bar_raw = bar_w + 2;
  uint64_t* bar_win = bar_w + 3;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const uint32_t rank = cluster_rank();
  // a cell tile's column tiles are neighbours in the grid: one cluster
  const int j0 = (int)(blockIdx.x % a.n_kt) * a.kt;
  const long long c0 = (long long)(blockIdx.x / a.n_kt) * C;
  const int kt = min(a.kt, a.k - j0);
  if (tid < 5) mbar_init(bar_w + tid, 1);
  if (tid == 0) {
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  // the steps: gene blocks in order, each in windows of win slot rows
  const int n_win = (a.width + a.win - 1) / a.win;
  const int steps = a.n_gb * n_win;
  const int pt = tid - kWalkWarps * 32;   // a stager's index

  if (tid < 32) {
    smem3[zero + tid] = 0.f;
    smem3[w_floats + zero + tid] = 0.f;
  }

  // this block's share of step `step`'s window: its first row and slots
  auto share_of = [&](int step, int& gb, int& w0, int& r0) {
    gb = step / n_win;
    w0 = (step - gb * n_win) * a.win;
    const int wn = min(a.win, a.width - w0);
    r0 = min(wn, (int)rank * share);
    return (min(wn, r0 + share) - r0) * C;
  };
  // one stager asks TMA for W's slice of gene block gb (into the buffer of
  // its parity), and for the ids and values of this block's share of a
  // step's window
  auto load_w = [&](int gb) {
    uint64_t* bar = bar_w + (gb & 1);
    float* s_w = smem3 + (gb & 1) * w_floats;
    mbar_expect_tx(bar, pieces * a.box_rows * a.kt * 4);
    for (int p = 0; p < pieces; ++p) {
      tma_load_3d(s_w + p * a.box_rows * a.kt, &tm_w, bar, j0,
                  p * a.box_rows, gb);
    }
  };
  uint32_t raw_phase = 0;
  auto load_raw = [&](int step) {
    int gb, w0, r0;
    if (share_of(step, gb, w0, r0) == 0) return;
    mbar_expect_tx(bar_raw,
                   (2 * share + (MODE == 2 ? a.bm_words : 0)) * C * 4);
    const int row = gb * a.width + w0 + r0;
    tma_load_2d(s_li, &tm_li, bar_raw, (int)c0, row);
    tma_load_2d(s_lv, &tm_lv, bar_raw, (int)c0, row);
    if (MODE == 2) {
      tma_load_3d(const_cast<uint32_t*>(s_bm), &tm_bm, bar_raw, (int)c0, 0,
                  gb);
    }
  };
  // The stagers keep-test a step's share once for the whole cluster, into
  // this block's window of the step's parity: per slot its W row's offset
  // and its value; a pad or held-out slot (or one past the cells) points at
  // the zero row with the value -0, whose fmaf leaves every sum as it is.
  // Then one stager asks for the next step's ids and values, copies the
  // share into the other blocks' windows (bulk copies, counted on their
  // window mbarriers) and arms this block's for the other blocks' shares.
  auto convert = [&](int step) {
    int gb, w0, r0;
    const int n = share_of(step, gb, w0, r0);
    const int b = step & 1;
    if (pt == 0 && a.cs > 1) {
      // the bytes the other blocks send: the step's rows but this share
      const int wn = min(a.win, a.width - w0);
      mbar_expect_tx(bar_win + b, (uint32_t)(wn * C - n) * 8);
    }
    if (n == 0) {
      if (pt == 0 && step + 1 < steps) load_raw(step + 1);
      return;
    }
    mbar_wait(bar_raw, raw_phase);
    raw_phase ^= 1u;
    int2* dst = s_win + (b * a.win + r0) * C;
    // a batch's ids, values and test bits are all in flight at once
    for (int i0 = 0; i0 < n; i0 += kStageThreads * kBatch) {
      int l[kBatch];
      int v[kBatch];
      uint32_t word[kBatch];
#pragma unroll
      for (int j = 0; j < kBatch; ++j) {
        const int i = i0 + pt + j * kStageThreads;
        const bool in = i < n && c0 + (i & (C - 1)) < a.cells;
        l[j] = in ? s_li[i] : -1;
        v[j] = in ? __float_as_int(s_lv[i]) : 0;
      }
#pragma unroll
      for (int j = 0; j < kBatch; ++j) {
        const int i = i0 + pt + j * kStageThreads;
        // the test bit where the slot's word would hold it
        word[j] = MODE == 2 && l[j] >= 0
                      ? ((s_bm[(l[j] >> 5) * C + (i & (C - 1))] >>
                          (l[j] & 31)) & 1u) << (gb & 31)
                      : 0u;
      }
#pragma unroll
      for (int j = 0; j < kBatch; ++j) {
        const int i = i0 + pt + j * kStageThreads;
        if (i < n) {
          const uint64_t xi =
              MODE == 1 ? cell_hash(a.seed, a.cell_offset + c0 + (i & (C - 1)))
                        : 0;
          const bool kept =
              l[j] >= 0 && slot_kept<MODE>(a, gb, xi, l[j], word[j]);
          dst[i] = kept ? make_int2(l[j] * a.kt, v[j])
                        : make_int2(zero, (int)0x80000000u);
        }
      }
    }
    // the share's generic stores, seen by the bulk copies' async proxy;
    // the ids and values are read
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    stagers_sync();
    if (pt == 0) {
      if (step + 1 < steps) load_raw(step + 1);
      const uint32_t src = smem_u32(dst);
      const uint32_t bar = smem_u32(bar_win + b);
      for (int t = 0; t < a.cs; ++t) {
        if (t != (int)rank) {
          bulk_to_cluster(cluster_addr(src, t), src, (uint32_t)n * 8,
                          cluster_addr(bar, t));
        }
      }
    }
  };

  cluster_sync();  // every block has started and set its barriers
  if (pt == 0 && steps > 0) {
    load_w(0);
    load_raw(0);
  }
  if (pt >= 0 && steps > 0) convert(0);
  cluster_sync();
  // walking: a quarter-warp per cell, lane q of it holds the columns
  // 4q .. 4q + 3 of the tile; the 16 walking warps take 64 cells at once
  const int q = lane & 7;
  const int sub = lane >> 3;
  float4 acc[kMaxRounds];
#pragma unroll
  for (int r = 0; r < kMaxRounds; ++r) acc[r] = make_float4(0.f, 0.f, 0.f, 0.f);
  for (int step = 0; step < steps; ++step) {
    const int gb = step / n_win;
    const int w0 = (step - gb * n_win) * a.win;
    if (pt < 0) {
      // each cell's slots in slot order, its W row's four columns from
      // shared memory, one fmaf chain per output; no branch, so the loads
      // of several slots are in flight at once
      if (w0 == 0) mbar_wait(bar_w + (gb & 1), (gb >> 1) & 1);
      if (a.cs > 1) mbar_wait(bar_win + (step & 1), (step >> 1) & 1);
      const int wn = min(a.win, a.width - w0);
      const float* wq = smem3 + (gb & 1) * w_floats + 4 * q;
      const int2* win = s_win + (step & 1) * a.win * C;
#pragma unroll
      for (int r = 0; r < kMaxRounds; ++r) {
        if (r < a.rounds) {
          const int2* pr = win + (r * kWalkWarps + warp) * 4 + sub;
          float4 t = acc[r];
#pragma unroll 4
          for (int w = 0; w < wn; ++w) {
            const int2 e = pr[w * C];
            const float4 x = *reinterpret_cast<const float4*>(wq + e.x);
            const float v = __int_as_float(e.y);
            t.x = fmaf(v, x.x, t.x);
            t.y = fmaf(v, x.y, t.y);
            t.z = fmaf(v, x.z, t.z);
            t.w = fmaf(v, x.w, t.w);
          }
          acc[r] = t;
        }
      }
    } else if (step + 1 < steps) {
      // the next gene block's W is asked for (its buffer was last read
      // before the last cluster barrier), then the next step is
      // keep-tested into every block's window
      if (pt == 0 && a.width - w0 <= a.win) load_w(gb + 1);
      convert(step + 1);
    }
    cluster_sync();  // the next step is staged in every block, walks done
  }

  if (pt >= 0) return;
#pragma unroll
  for (int r = 0; r < kMaxRounds; ++r) {
    const long long cell = c0 + (r * kWalkWarps + warp) * 4 + sub;
    if (r < a.rounds && cell < a.cells && 4 * q < kt) {
      float* out = a.B + cell * a.k + j0 + 4 * q;
      const int n = min(4, kt - 4 * q);
      out[0] = acc[r].x;
      if (n > 1) out[1] = acc[r].y;
      if (n > 2) out[2] = acc[r].z;
      if (n > 3) out[3] = acc[r].w;
    }
  }
}

// raise a kernel's dynamic shared-memory limit to kMaxSmem (and, with
// `carveout`, its shared-memory share of L1 to the most), once per device:
// `raised` holds one bit per device
template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, unsigned long long& raised,
                       bool carveout) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < 64 && ((raised >> dev) & 1ull)) return cudaSuccess;
  err = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)kMaxSmem);
  if (err == cudaSuccess && carveout) {
    err = cudaFuncSetAttribute(kernel,
                               cudaFuncAttributePreferredSharedMemoryCarveout,
                               (int)cudaSharedmemCarveoutMaxShared);
  }
  if (err == cudaSuccess && dev < 64) raised |= 1ull << dev;
  return err;
}

template <int MODE>
cudaError_t launch_b3(const B3Args& a, const CUtensorMap* maps, unsigned grid,
                      size_t smem, cudaStream_t stream) {
  static unsigned long long raised = 0;
  const cudaError_t err = allow_smem(bell_spmm_kernel<MODE>, raised, true);
  if (err != cudaSuccess) return err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(grid);
  cfg.blockDim = dim3(kThreads3);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = a.cs;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(&cfg, bell_spmm_kernel<MODE>, a, maps[0], maps[1],
                            maps[2], maps[3]);
}

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

// a TMA view of `base` with `rank` dims (innermost first), byte strides of
// the outer dims, and boxes of `box`; zeros past the dims
bool tensor_map(CUtensorMap* map, CUtensorMapDataType type, int rank,
                const void* base, const cuuint64_t* dims,
                const cuuint64_t* strides, const cuuint32_t* box) {
  const EncodeTiled encode = encoder();
  const cuuint32_t unit[3] = {1, 1, 1};
  return encode != nullptr &&
         encode(map, type, rank, const_cast<void*>(base), dims, strides, box,
                unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
                CU_TENSOR_MAP_SWIZZLE_NONE, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
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

// ---- B3 and B5 on wide gene blocks ------------------------------------------

constexpr int kWideThreads = 256;   // a block of the wide-block route
constexpr int kWideRows = 32;       // slot rows a window
constexpr int kWideLoads = 16;      // loads of W's rows a lane has in flight

// the fields `slot_kept` reads, and the route's own
struct B3WideArgs {
  const int32_t* li;
  const float* lv;
  long long ld;
  int n_gb, width, cells, gene_block;
  const float* W;      // (n_gb * gene_block, k), row stride ldw
  long long ldw;       // a multiple of VW, W aligned to VW floats
  int k;
  float* B;            // (cells, k)
  uint64_t seed;
  long long cell_offset;
  int shift;
  uint64_t odd_inverse;
  uint64_t odd_limit;
  const uint32_t* words;
  long long wld;
};

// VW adjacent floats of W a load: float4 or float2
template <int VW>
struct WideVec;
template <>
struct WideVec<4> {
  using T = float4;
  __device__ static T zero() { return make_float4(0.f, 0.f, 0.f, 0.f); }
  __device__ static void fma(float s, const T& x, T& acc) {
    acc.x = fmaf(s, x.x, acc.x);
    acc.y = fmaf(s, x.y, acc.y);
    acc.z = fmaf(s, x.z, acc.z);
    acc.w = fmaf(s, x.w, acc.w);
  }
  __device__ static void store(float* out, const T& acc, int n) {
    out[0] = acc.x;
    if (n > 1) out[1] = acc.y;
    if (n > 2) out[2] = acc.z;
    if (n > 3) out[3] = acc.w;
  }
};
template <>
struct WideVec<2> {
  using T = float2;
  __device__ static T zero() { return make_float2(0.f, 0.f); }
  __device__ static void fma(float s, const T& x, T& acc) {
    acc.x = fmaf(s, x.x, acc.x);
    acc.y = fmaf(s, x.y, acc.y);
  }
  __device__ static void store(float* out, const T& acc, int n) {
    out[0] = acc.x;
    if (n > 1) out[1] = acc.y;
  }
};

// keep mode MODE; L lanes a cell, C = 256 / L cells a block (blockIdx.x
// their tile); V vectors of VW floats of W a lane: lane q holds the
// columns j0 + VW (q + L v) .. + VW - 1, v < V, of the column chunk j0 =
// blockIdx.y * VW L V
template <int MODE, int L, int V, int VW>
__global__ void __launch_bounds__(kWideThreads)
bell_spmm_wide_kernel(const B3WideArgs a) {
  using Vec = WideVec<VW>;
  using VT = typename Vec::T;
  constexpr int C = kWideThreads / L;
  constexpr int NS = kWideRows / L;      // slots a thread stages a window
  constexpr int U = kWideLoads / V;      // slots a lane walks at once
  // rows padded to C + 1 pairs (measured faster for B5 at k = 100)
  __shared__ int2 s_win[2][kWideRows][C + 1];
  const int tid = threadIdx.x;
  const long long c0 = (long long)blockIdx.x * C;
  const int n_win = (a.width + kWideRows - 1) / kWideRows;
  const int steps = a.n_gb * n_win;    // gene blocks in order, in windows

  // staging: thread tid stages cell sc's slot rows sr + L i of a window,
  // neighbouring threads on neighbouring cells
  const int sc = tid % C;
  const int sr = tid / C;
  const long long scell = c0 + sc;
  const bool s_in = scell < a.cells;
  const uint64_t xi =
      MODE == 1 && s_in ? cell_hash(a.seed, a.cell_offset + scell) : 0;
  auto load_ids = [&](int step, int (&l)[NS], float (&v)[NS]) {
    const int gb = step / n_win;
    const int w0 = (step - gb * n_win) * kWideRows;
#pragma unroll
    for (int i = 0; i < NS; ++i) {
      const int w = w0 + sr + L * i;
      l[i] = -1;
      v[i] = 0.f;
      if (step < steps && s_in && w < a.width) {
        const long long off = (long long)(gb * a.width + w) * a.ld + scell;
        l[i] = __ldg(a.li + off);
        v[i] = __ldg(a.lv + off);
      }
    }
  };
  auto load_words = [&](int step, const int (&l)[NS], uint32_t (&wd)[NS]) {
    const long long t = step / n_win >> 5;
#pragma unroll
    for (int i = 0; i < NS; ++i) {
      wd[i] = MODE == 2 && l[i] >= 0
                  ? __ldg(a.words + scell * a.wld + t * a.gene_block + l[i])
                  : 0u;
    }
  };
  // the window's (W row, value) pairs, a pad or held-out slot row -1
  auto stage = [&](int step, const int (&l)[NS], const float (&v)[NS],
                   const uint32_t (&wd)[NS]) {
    const int gb = step / n_win;
#pragma unroll
    for (int i = 0; i < NS; ++i) {
      const bool kept = l[i] >= 0 && slot_kept<MODE>(a, gb, xi, l[i], wd[i]);
      s_win[step & 1][sr + L * i][sc] =
          kept ? make_int2(gb * a.gene_block + l[i], __float_as_int(v[i]))
               : make_int2(-1, 0);
    }
  };

  // walking: cell cw of the block, lane q of it
  const int cw = tid / L;
  const int q = tid % L;
  const int j0 = blockIdx.y * VW * L * V;
  const float* wq = a.W + j0 + VW * q;
  bool col[V];
  VT acc[V];
#pragma unroll
  for (int v = 0; v < V; ++v) {
    col[v] = j0 + VW * (q + L * v) < a.k;
    acc[v] = Vec::zero();
  }
  auto walk = [&](int step) {
    const int w0 = (step - step / n_win * n_win) * kWideRows;
    const int wn = min(kWideRows, a.width - w0);
    const int2* win = &s_win[step & 1][0][cw];
    for (int w = 0; w < wn; w += U) {
      int2 e[U];
#pragma unroll
      for (int u = 0; u < U; ++u) {
        e[u] = w + u < wn ? win[(w + u) * (C + 1)] : make_int2(-1, 0);
      }
      VT x[U][V];
#pragma unroll
      for (int u = 0; u < U; ++u) {
#pragma unroll
        for (int v = 0; v < V; ++v) {
          x[u][v] = e[u].x >= 0 && col[v]
                        ? __ldg(reinterpret_cast<const VT*>(
                              wq + (long long)e[u].x * a.ldw + VW * L * v))
                        : Vec::zero();
        }
      }
#pragma unroll
      for (int u = 0; u < U; ++u) {
        if (e[u].x < 0) continue;   // a skipped slot adds nothing
        const float sv = __int_as_float(e[u].y);
#pragma unroll
        for (int v = 0; v < V; ++v) Vec::fma(sv, x[u][v], acc[v]);
      }
    }
  };

  // window `step` staged; the next one's ids with their words, and the
  // ids of the one after, in flight
  int l_next[NS], l_far[NS];
  float v_next[NS], v_far[NS];
  uint32_t wd_next[NS];
  if (steps > 0) {
    load_ids(0, l_next, v_next);
    load_words(0, l_next, wd_next);
    stage(0, l_next, v_next, wd_next);
    load_ids(1, l_next, v_next);
    load_words(1, l_next, wd_next);
    load_ids(2, l_far, v_far);
  }
  __syncthreads();
  for (int step = 0; step < steps; ++step) {
    walk(step);
    if (step + 1 < steps) stage(step + 1, l_next, v_next, wd_next);
#pragma unroll
    for (int i = 0; i < NS; ++i) {
      l_next[i] = l_far[i];
      v_next[i] = v_far[i];
    }
    load_words(step + 2, l_next, wd_next);
    load_ids(step + 3, l_far, v_far);
    __syncthreads();   // the next window staged, this one walked
  }

  const long long cell = c0 + cw;
  if (cell >= a.cells) return;
  float* out = a.B + cell * a.k;
#pragma unroll
  for (int v = 0; v < V; ++v) {
    const int j = j0 + VW * (q + L * v);
    if (col[v]) Vec::store(out + j, acc[v], min(VW, a.k - j));
  }
}

template <int MODE, int L, int V, int VW>
cudaError_t launch_wide_lv(const B3WideArgs& a, dim3 grid, cudaStream_t s) {
  bell_spmm_wide_kernel<MODE, L, V, VW><<<grid, kWideThreads, 0, s>>>(a);
  return cudaGetLastError();
}

// the instantiation of (lanes a cell, vectors a lane, floats a vector)
template <int MODE>
cudaError_t launch_wide(const B3WideArgs& a, int lanes, int vec, int vw,
                        dim3 grid, cudaStream_t s) {
  switch ((lanes * 4 + vec) * 8 + vw) {
    case (4 * 4 + 1) * 8 + 4: return launch_wide_lv<MODE, 4, 1, 4>(a, grid, s);
    case (8 * 4 + 1) * 8 + 4: return launch_wide_lv<MODE, 8, 1, 4>(a, grid, s);
    case (16 * 4 + 1) * 8 + 4:
      return launch_wide_lv<MODE, 16, 1, 4>(a, grid, s);
    case (32 * 4 + 1) * 8 + 4:
      return launch_wide_lv<MODE, 32, 1, 4>(a, grid, s);
    case (32 * 4 + 2) * 8 + 4:
      return launch_wide_lv<MODE, 32, 2, 4>(a, grid, s);
    case (4 * 4 + 1) * 8 + 2: return launch_wide_lv<MODE, 4, 1, 2>(a, grid, s);
    case (8 * 4 + 1) * 8 + 2: return launch_wide_lv<MODE, 8, 1, 2>(a, grid, s);
    case (16 * 4 + 1) * 8 + 2:
      return launch_wide_lv<MODE, 16, 1, 2>(a, grid, s);
    case (32 * 4 + 1) * 8 + 2:
      return launch_wide_lv<MODE, 32, 1, 2>(a, grid, s);
    case (32 * 4 + 2) * 8 + 2:
      return launch_wide_lv<MODE, 32, 2, 2>(a, grid, s);
    default: return cudaErrorInvalidValue;
  }
}

template <int VEC, int MODE>
cudaError_t launch_b4(const B4Args& a, dim3 grid, size_t smem,
                      cudaStream_t stream) {
  static unsigned long long raised = 0;
  const cudaError_t err = allow_smem(bell_spmm_t_kernel<VEC, MODE>, raised,
                                     false);
  if (err != cudaSuccess) return err;
  bell_spmm_t_kernel<VEC, MODE><<<grid, kThreadsT, smem, stream>>>(a);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Device pointers: li int32 / lv float32 planes, row r at r * ld; W
// (n_gb * gene_block, k) float32 with row stride ldw; B (cells, k)
// contiguous float32. `masked`: 0 keep all, 1 hash (seed, cell_offset,
// inv_density), 2 words (cells rows of row stride `wld`, the packed test
// mask of these cells; `bm` holds n_gb * b3_bm_words(gene_block) *
// round_up(cells, 4) words of scratch, the test bits by gene block that a
// first kernel writes). The host plan of ops/bell_cuda.py `b3_plan`: column tiles of
// `kt` columns (a multiple of 4, at most 32), cell tiles of 64 * `rounds`
// (1, 2 or 4), slot windows of `win` rows, clusters of `cs` blocks (1 or
// 2, dividing the column tiles). TMA reads W and the planes: their
// addresses are multiples of 16 bytes, and ld and ldw of 4 (the wrapper
// copies what is not). One launch for any k (mode 2: the test bits' pass,
// then it). Returns the cudaError_t of the launch (0 on success).
int bell_spmm(const int32_t* li, const float* lv, long long ld, int n_gb,
              int width, int cells, int gene_block, const float* W,
              long long ldw, int k, float* B, int kt, int rounds, int win,
              int cs, int masked, uint64_t seed, long long cell_offset,
              int inv_density, const uint32_t* words, long long wld,
              uint32_t* bm, void* stream) {
  if (cells <= 0 || k <= 0) return cudaSuccess;
  const int n_kt = (k + kt - 1) / kt;
  const int C = kCellsPass * rounds;
  const int share = b3_share(win, cs);
  const int bm_words = masked == 2 ? b3_bm_words(gene_block) : 0;
  const long long smem =
      b3_smem_bytes(gene_block, win, kt, rounds, cs, bm_words);
  const long long grid = (long long)((cells + C - 1) / C) * n_kt;
  if (inv_density < 1 || masked < 0 || masked > 2 ||
      (masked == 2 && (words == nullptr || bm == nullptr ||
                       reinterpret_cast<uintptr_t>(bm) % 16 != 0)) ||
      n_gb < 0 || width < 0 || gene_block < 1 || kt < 4 ||
      kt > kColTile3 || kt % 4 != 0 ||
      (rounds != 1 && rounds != 2 && rounds != 4) || win < 1 ||
      (cs != 1 && cs != 2) || n_kt % cs != 0 || share > 256 ||
      bm_words > 256 || ld % 4 != 0 || ldw % 4 != 0 || ldw < k ||
      reinterpret_cast<uintptr_t>(li) % 16 != 0 ||
      reinterpret_cast<uintptr_t>(lv) % 16 != 0 ||
      reinterpret_cast<uintptr_t>(W) % 16 != 0 || smem > kMaxSmem ||
      grid > 0x7fffffffLL) {
    return cudaErrorInvalidValue;
  }
  const int box_rows = gene_block < 256 ? gene_block : 256;
  CUtensorMap maps[4];
  const cuuint64_t w_dims[3] = {(cuuint64_t)k, (cuuint64_t)gene_block,
                                (cuuint64_t)(n_gb > 0 ? n_gb : 1)};
  const cuuint64_t w_strides[2] = {(cuuint64_t)ldw * 4,
                                   (cuuint64_t)ldw * 4 * gene_block};
  const cuuint32_t w_box[3] = {(cuuint32_t)kt, (cuuint32_t)box_rows, 1};
  const long long rows = (long long)n_gb * width;
  const cuuint64_t p_dims[2] = {(cuuint64_t)cells,
                                (cuuint64_t)(rows > 0 ? rows : 1)};
  const cuuint64_t p_strides[1] = {(cuuint64_t)ld * 4};
  const cuuint32_t p_box[2] = {(cuuint32_t)C, (cuuint32_t)share};
  const long long bm_ld = (cells + 3) / 4 * 4;
  const cuuint64_t m_dims[3] = {(cuuint64_t)cells, (cuuint64_t)bm_words,
                                (cuuint64_t)(n_gb > 0 ? n_gb : 1)};
  const cuuint64_t m_strides[2] = {(cuuint64_t)bm_ld * 4,
                                   (cuuint64_t)bm_ld * 4 * bm_words};
  const cuuint32_t m_box[3] = {(cuuint32_t)C, (cuuint32_t)bm_words, 1};
  if (!tensor_map(&maps[0], CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 3, W, w_dims,
                  w_strides, w_box) ||
      !tensor_map(&maps[1], CU_TENSOR_MAP_DATA_TYPE_INT32, 2, li, p_dims,
                  p_strides, p_box) ||
      !tensor_map(&maps[2], CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 2, lv, p_dims,
                  p_strides, p_box) ||
      (masked == 2 && !tensor_map(&maps[3], CU_TENSOR_MAP_DATA_TYPE_UINT32, 3,
                                  bm, m_dims, m_strides, m_box))) {
    return cudaErrorInvalidValue;
  }
  if (masked != 2) maps[3] = maps[1];
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (masked == 2) {
    const long long blocks = (cells + kBmCells - 1) / kBmCells *
                             ((n_gb + 31) / 32) *
                             ((bm_words + kBmWords - 1) / kBmWords);
    bell_words_t_kernel<<<(unsigned)blocks, 256, 0, s>>>(
        words, wld, cells, n_gb, gene_block, bm_words, bm_ld, bm);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  const OddDivisor d = odd_divisor((uint64_t)inv_density);
  const B3Args a{n_gb, width, cells, gene_block, k, B, kt, n_kt, rounds,
                 win, cs, box_rows, masked, seed, cell_offset, d.shift,
                 d.inverse, d.limit, bm_words};
  const unsigned g = (unsigned)grid;
  switch (masked) {
    case 0: return launch_b3<0>(a, maps, g, (size_t)smem, s);
    case 1: return launch_b3<1>(a, maps, g, (size_t)smem, s);
    default: return launch_b3<2>(a, maps, g, (size_t)smem, s);
  }
}

// The wide-block route of B3 (keep mode 0 or 1) and B5 (mode 2), for any
// gene block and any k, on the host plan of ops/bell_cuda.py `b3_plan`
// (`B3WidePlan`): column chunks of `cols` columns and blocks of
// `cell_tile` cells (256 / lanes a cell: 64, 32, 16 or 8), each lane
// `vw` adjacent floats of W a load (4 or 2) and cols / (vw lanes) loads
// a row (1 or 2), W's rows read from device memory (W aligned to vw
// floats, row stride ldw a multiple of vw), the words read in place (no
// pass). The other arguments as bell_spmm's. Returns the cudaError_t of
// the launch (0 on success).
int bell_spmm_wide(const int32_t* li, const float* lv, long long ld,
                   int n_gb, int width, int cells, int gene_block,
                   const float* W, long long ldw, int k, float* B, int cols,
                   int cell_tile, int vw, int masked, uint64_t seed,
                   long long cell_offset, int inv_density,
                   const uint32_t* words, long long wld, void* stream) {
  if (cells <= 0 || k <= 0) return cudaSuccess;
  const int lanes = cell_tile > 0 ? kWideThreads / cell_tile : 0;
  const int vec = lanes > 0 && vw > 0 ? cols / (vw * lanes) : 0;
  const long long blocks = cell_tile > 0 ? (cells + cell_tile - 1) / cell_tile
                                         : 0;
  const long long chunks = cols > 0 ? (k + cols - 1) / cols : 0;
  if (inv_density < 1 || masked < 0 || masked > 2 ||
      (masked == 2 && words == nullptr) || n_gb < 0 || width < 0 ||
      gene_block < 1 || ldw < k || (vw != 2 && vw != 4) || ldw % vw != 0 ||
      reinterpret_cast<uintptr_t>(W) % (4 * vw) != 0 ||
      lanes * cell_tile != kWideThreads || cols != vw * lanes * vec ||
      blocks < 1 || blocks > 0x7fffffffLL || chunks < 1 || chunks > 65535 ||
      (long long)n_gb * gene_block > 0x7fffffffLL) {
    return cudaErrorInvalidValue;
  }
  const OddDivisor d = odd_divisor((uint64_t)inv_density);
  const B3WideArgs a{li, lv, ld, n_gb, width, cells, gene_block, W, ldw, k,
                     B, seed, cell_offset, d.shift, d.inverse, d.limit,
                     words, wld};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 grid((unsigned)blocks, (unsigned)chunks);
  switch (masked) {
    case 0: return launch_wide<0>(a, lanes, vec, vw, grid, s);
    case 1: return launch_wide<1>(a, lanes, vec, vw, grid, s);
    default: return launch_wide<2>(a, lanes, vec, vw, grid, s);
  }
}

// As bell_spmm, with H (cells, k) and Bw (n_gb * gene_block, k), on the
// host plan of ops/bell_cuda.py `b4_plan`: `rows` gene rows a block,
// `n_chunks` chunks of `chunk_tiles` tiles of 64 cells.
// With n_chunks > 1, `partials` holds (n_chunks, n_gb * gene_block, k)
// floats of scratch and `counters` one int per output tile (n_gb *
// ceil(gene_block / rows) * ceil(k / 128) of them), zeroed here. `h_vec` (4, 2
// or 1) is the floats per copy of H: k and H's address are multiples of it.
int bell_spmm_t(const int32_t* li, const float* lv, long long ld, int n_gb,
                int width, int cells, int gene_block, const float* H, int k,
                float* Bw, float* partials, int* counters, int rows,
                int chunk_tiles, int n_chunks, int h_vec, int p_vec,
                int masked,
                uint64_t seed, long long cell_offset, int inv_density,
                const uint32_t* words, long long wld, void* stream) {
  if (k <= 0 || n_gb <= 0 || gene_block <= 0 || cells <= 0) {
    return cudaSuccess;
  }
  const int vec = b4_vec(k);
  const long long n_tiles = (cells + kTile - 1) / kTile;
  const long long smem = b4_smem_bytes(rows, k);
  if (inv_density < 1 || masked < 0 || masked > 2 ||
      (masked == 2 && words == nullptr) || rows < 1 ||
      rows > kWarpsT * b4_genes(vec) || chunk_tiles < 1 ||
      n_chunks < 1 || n_chunks > 65535 ||
      (long long)chunk_tiles * n_chunks < n_tiles ||
      (n_chunks > 1 && (partials == nullptr || counters == nullptr)) ||
      (h_vec != 1 && h_vec != 2 && h_vec != 4) || k % h_vec != 0 ||
      reinterpret_cast<uintptr_t>(H) % (4 * h_vec) != 0 ||
      (p_vec != 1 && p_vec != 4) ||
      (p_vec == 4 && (ld % 4 != 0 || reinterpret_cast<uintptr_t>(li) % 16 ||
                      reinterpret_cast<uintptr_t>(lv) % 16)) ||
      smem > kMaxSmem) {
    return cudaErrorInvalidValue;
  }
  const OddDivisor d = odd_divisor((uint64_t)inv_density);
  const B4Args a{li, lv, ld, n_gb, width, cells, gene_block, H, k, Bw,
                 partials, counters, rows, chunk_tiles, n_chunks, h_vec,
                 p_vec, masked, seed, cell_offset, d.shift, d.inverse,
                 d.limit, words, wld};
  const int n_rg = (gene_block + rows - 1) / rows;
  const dim3 grid(n_gb * n_rg, (k + kColTile - 1) / kColTile, n_chunks);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n_chunks > 1) {
    const cudaError_t err = cudaMemsetAsync(
        counters, 0, sizeof(int) * grid.x * grid.y, s);
    if (err != cudaSuccess) return err;
  }
  switch (vec * 3 + masked) {
    case 3: return launch_b4<1, 0>(a, grid, (size_t)smem, s);
    case 4: return launch_b4<1, 1>(a, grid, (size_t)smem, s);
    case 5: return launch_b4<1, 2>(a, grid, (size_t)smem, s);
    case 6: return launch_b4<2, 0>(a, grid, (size_t)smem, s);
    case 7: return launch_b4<2, 1>(a, grid, (size_t)smem, s);
    case 8: return launch_b4<2, 2>(a, grid, (size_t)smem, s);
    case 12: return launch_b4<4, 0>(a, grid, (size_t)smem, s);
    case 13: return launch_b4<4, 1>(a, grid, (size_t)smem, s);
    default: return launch_b4<4, 2>(a, grid, (size_t)smem, s);
  }
}

const char* bell_spmm_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"

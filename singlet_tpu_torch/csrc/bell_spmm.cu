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
// (gb & 31) & 1, one load and one shift per slot in place of the hash.
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
// B3: one warp per cell. Lane l reads slot w0 + l of the cell (the eight
// warps of a block take eight neighbouring cells, so a 32-byte sector of a
// plane row serves the whole block from L1), hashes its own slot, and the
// warp then walks the live slots in order: each one broadcast by shuffle,
// the lanes gather W's row (coalesced, k floats; W is 6.5 MB at k=100 and
// stays in L2) and accumulate the cell's k outputs in registers. Each
// output is one thread's sum in a fixed order: deterministic. A lane holds
// at most 7 outputs (k <= 224); the wrapper (ops/bell_cuda.py) launches a
// wider W in column chunks of at most 224, which gives the same sums, since
// no output's sum depends on the other columns.
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

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kWarps = 8;                       // B3: warps (cells) per block
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

__device__ __forceinline__ bool held_out(uint64_t xi, uint64_t j,
                                         uint64_t inv_density) {
  j ^= j >> 7;
  j ^= j << 23;
  j ^= j >> 8;
  uint64_t x = xi + j;
  x ^= x >> 7;
  x ^= x << 53;
  x ^= x >> 4;
  return x % inv_density == 0;
}

// global cell and gene ids enter the hash as uint32, as in rngmask.py
__device__ __forceinline__ uint64_t cell_hash(uint64_t seed,
                                              long long cell_id) {
  return hash_i(seed, (uint64_t)(uint32_t)cell_id);
}

// keep mode 2: whether the packed words hold cell c's test bit at gene
// block gb, local gene l (`wrow` is cell c's row of words)
__device__ __forceinline__ bool word_bit(const uint32_t* __restrict__ wrow,
                                         int gb, int gene_block, int l) {
  return (wrow[(gb >> 5) * gene_block + l] >> (gb & 31)) & 1u;
}

template <int NPL>  // output columns per lane: k <= 32 * NPL
__global__ void __launch_bounds__(kWarps * 32)
bell_spmm_kernel(const int32_t* __restrict__ li, const float* __restrict__ lv,
                 long long ld, int n_gb, int width, int cells,
                 int gene_block, const float* __restrict__ W, int k,
                 float* __restrict__ B, int masked, uint64_t seed,
                 long long cell_offset, uint64_t inv_density,
                 const uint32_t* __restrict__ words, long long wld) {
  const int lane = threadIdx.x & 31;
  const long long c = (long long)blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (c >= cells) return;  // whole warps only
  const uint64_t xi = masked == 1 ? cell_hash(seed, cell_offset + c) : 0;
  const uint32_t* wrow = masked == 2 ? words + c * wld : nullptr;
  float acc[NPL];
#pragma unroll
  for (int s = 0; s < NPL; ++s) acc[s] = 0.f;

  for (int gb = 0; gb < n_gb; ++gb) {
    for (int w0 = 0; w0 < width; w0 += 32) {
      const int w = w0 + lane;
      int g = -1;
      float v = 0.f;
      if (w < width) {
        const long long off = (long long)(gb * width + w) * ld + c;
        const int l = li[off];
        if (l >= 0) {
          g = gb * gene_block + l;
          v = lv[off];
          if ((masked == 1 &&
               held_out(xi, (uint64_t)(uint32_t)g, inv_density)) ||
              (masked == 2 && word_bit(wrow, gb, gene_block, l))) {
            g = -1;  // held out: keep = 0, the entry adds nothing
          }
        }
      }
      unsigned live = __ballot_sync(kFull, g >= 0);
      while (live) {
        const int j = __ffs(live) - 1;
        live &= live - 1;
        const int gj = __shfl_sync(kFull, g, j);
        const float vj = __shfl_sync(kFull, v, j);
        const float* w_row = W + (long long)gj * k;
#pragma unroll
        for (int s = 0; s < NPL; ++s) {
          const int col = s * 32 + lane;
          if (col < k) acc[s] = fmaf(vj, w_row[col], acc[s]);
        }
      }
    }
  }
  float* b_row = B + c * k;
#pragma unroll
  for (int s = 0; s < NPL; ++s) {
    const int col = s * 32 + lane;
    if (col < k) b_row[col] = acc[s];
  }
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
// (mode 2)
template <int MODE>
__device__ __forceinline__ bool b4_kept(const B4Args& a, int gb, uint64_t xi,
                                        int l, uint32_t word) {
  if (MODE == 1) {
    // held_out's mix, then its divisibility test as a multiply
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
            b4_kept<MODE>(a, gb, xi, l, MODE == 2 ? __ldg(wrow + l) : 0u)) {
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
            if (!b4_kept<MODE>(a, gb, xi, l, word)) continue;
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

template <int NPL>
cudaError_t launch_b3(const int32_t* li, const float* lv, long long ld,
                      int n_gb, int width, int cells, int gene_block,
                      const float* W, int k, float* B, int masked,
                      uint64_t seed, long long cell_offset,
                      uint64_t inv_density, const uint32_t* words,
                      long long wld, cudaStream_t stream) {
  const int blocks = (cells + kWarps - 1) / kWarps;
  bell_spmm_kernel<NPL><<<blocks, kWarps * 32, 0, stream>>>(
      li, lv, ld, n_gb, width, cells, gene_block, W, k, B, masked, seed,
      cell_offset, inv_density, words, wld);
  return cudaGetLastError();
}

template <int VEC, int MODE>
cudaError_t launch_b4(const B4Args& a, dim3 grid, size_t smem,
                      cudaStream_t stream) {
  // raise the kernel's shared-memory limit once per device
  static unsigned long long raised = 0;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev >= 64 || !((raised >> dev) & 1ull)) {
    err = cudaFuncSetAttribute(bell_spmm_t_kernel<VEC, MODE>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)kMaxSmem);
    if (err != cudaSuccess) return err;
    if (dev < 64) raised |= 1ull << dev;
  }
  bell_spmm_t_kernel<VEC, MODE><<<grid, kThreadsT, smem, stream>>>(a);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Device pointers: li int32 / lv float32 planes, row r at r * ld; W
// (n_gb * gene_block, k) and B (cells, k) contiguous float32. `masked`: 0
// keep all, 1 hash (seed, cell_offset, inv_density), 2 words (cells rows of
// row stride `wld`, the packed test mask of these cells). Returns the
// cudaError_t of the launch (0 on success).
int bell_spmm(const int32_t* li, const float* lv, long long ld, int n_gb,
              int width, int cells, int gene_block, const float* W, int k,
              float* B, int masked, uint64_t seed, long long cell_offset,
              int inv_density, const uint32_t* words, long long wld,
              void* stream) {
  if (cells <= 0 || k <= 0) return cudaSuccess;
  if (inv_density < 1 || masked < 0 || masked > 2 ||
      (masked == 2 && words == nullptr)) {
    return cudaErrorInvalidValue;
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const uint64_t d = (uint64_t)inv_density;
  switch ((k + 31) / 32) {
    case 1: return launch_b3<1>(li, lv, ld, n_gb, width, cells, gene_block, W, k, B, masked, seed, cell_offset, d, words, wld, s);
    case 2: return launch_b3<2>(li, lv, ld, n_gb, width, cells, gene_block, W, k, B, masked, seed, cell_offset, d, words, wld, s);
    case 3: return launch_b3<3>(li, lv, ld, n_gb, width, cells, gene_block, W, k, B, masked, seed, cell_offset, d, words, wld, s);
    case 4: return launch_b3<4>(li, lv, ld, n_gb, width, cells, gene_block, W, k, B, masked, seed, cell_offset, d, words, wld, s);
    case 5: return launch_b3<5>(li, lv, ld, n_gb, width, cells, gene_block, W, k, B, masked, seed, cell_offset, d, words, wld, s);
    case 6: return launch_b3<6>(li, lv, ld, n_gb, width, cells, gene_block, W, k, B, masked, seed, cell_offset, d, words, wld, s);
    case 7: return launch_b3<7>(li, lv, ld, n_gb, width, cells, gene_block, W, k, B, masked, seed, cell_offset, d, words, wld, s);
    default: return cudaErrorInvalidValue;
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
  int shift = 0;
  uint64_t odd = (uint64_t)inv_density;
  while (!(odd & 1)) {
    odd >>= 1;
    ++shift;
  }
  uint64_t inverse = odd;  // Newton: each step doubles the correct bits
  for (int i = 0; i < 5; ++i) inverse *= 2 - odd * inverse;
  const B4Args a{li, lv, ld, n_gb, width, cells, gene_block, H, k, Bw,
                 partials, counters, rows, chunk_tiles, n_chunks, h_vec,
                 p_vec, masked, seed, cell_offset, shift, inverse,
                 ~0ull / odd, words, wld};
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

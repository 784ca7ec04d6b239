// Batched warm-started coordinate-descent NNLS with one Gram matrix per
// column: kernel B2 of the port, for sm_90a.
//
// Replaces singlet_tpu/ops/pallas_nnls.py `nnls_batch_pallas_batched_at`
// (kernel body `_nnls_kernel_batched`), the solve of the masked
// (cross-validation) half-updates. For every column c it computes what the
// plain version `singlet_tpu_torch.ops.nnls.nnls_batch` computes with the
// (n, k, k) Gram a_c:
//
//   repeat sweeps:  for i in 0..k-1:
//     diff  = b_i * inv_c[i] - L1[c, i] + L2 * x_i   (L1 scalar or (n, k))
//     delta = max(diff, -x_i)       (clamp at zero; a NaN kept, `cd_clamp`)
//     x_i  += delta;  b_j -= a_c[j, i] * delta   for all j
//   tol = sum_i |x_i - x_prev_i| / (x_i + 1e-15)
//   stop when tol / k_div <= 1e-8, or sweep >= max_sweeps, or sweep >= cap
//
// b starts at the RAW right-hand side and x at X0; columns whose mask byte
// is 0 return X0 bit for bit. inv_c[i] = 1 / a_c[i, i]: the tile entry
// takes it from the wrapper, computed by PyTorch as the plain version
// computes it; the packed entry forms it with the same subtraction and a
// correctly rounded reciprocal, the same bits.
//
// Two entries share one kernel body. `nnls_cd_batched` reads the Grams as
// the coordinate tiles at (k, k, n), at[i, j, c] = a_c[j, i]. The masked
// half-updates call `nnls_cd_batched_packed`, which reads what the tile is
// made of: a_full (k, k), shared by every column, and the packed
// corrections packed_t (k (k + 1) / 2, n), so that
//   a_c[j, i] = a_full[i, j] - packed_t[pos(i, j), c]
// with one __fsub_rn: the bits of `unpack_sym_from_t`, without writing the
// (k, k, n) tile (82 MB per 2048-column block at k = 100). pos comes from
// the wrapper's table of row starts, pos(r, j >= r) = row_start[r] + j - r
// (the row-major upper triangle of `triu_pairs`). a_full is not
// bit-symmetric (X^T X), so the tile cannot be one mirrored triangle; the
// corrections are, and a column's packed Gram is half of its full one
// (20.2 KB against 40 KB at k = 100).
//
// What bounds B2, and the design. Each step is a serial chain: the
// owner's diff and clamp, the broadcast of delta, and the downdate of the
// next owner's b; k steps a sweep, 32 or 100 sweeps. The parent spread a
// column over eight warps (a lane per column) and paid a block barrier per
// step and a Gram re-read from device memory per sweep (about 2,000 cycles
// a step). Here a column belongs to a warp (k > 64) or to half a warp
// (k <= 64, two columns a warp that share the loads of a_full): lane l
// owns coordinates l, l + W, ... (W = 32 or 16) and keeps their b, x and
// 1/diag in registers; at step i the owner lane computes delta and
// broadcasts it by __shfl_sync; there is no barrier. A block is C <= 8
// neighbouring columns: it stages their Grams into shared memory once
// (16-byte loads of 4 neighbouring columns, whole 32-byte sectors, at C =
// 8), crosses its only barrier, and each warp then sweeps from shared
// memory until its columns stop. The step's chain alone takes about 60
// cycles (`ab_nnls_batched`'s chain probe on an H100); to keep it short,
// a step first downdates only the owner's slot by the previous delta,
// shuffles, and only then downdates the other slots and loads the Gram
// entries of the step after next (two steps ahead: loads one step ahead
// were sunk onto the chain by the compiler). Within a slot the owner's
// slot is known when compiling, so only one slot of lanes chooses between
// the triangle's row and column. What then bounds it is issue: about 50
// instructions a step (19 of them arithmetic, 8 shared loads) with two
// warps per scheduler at k = 100 (shared memory holds 8 columns per SM:
// 202 KB a block), about 170 cycles a step. Where the Gram does not fit,
// it streams:
//
//   mode          Gram in shared memory            streamed             k (C)
//   kPackedSmem   a_full, C packed columns         -                    <= 106 (8)
//   kPackedRingA  C packed columns                 a_full rows          107..320 (1..8)
//   kPackedRing   -                                a_full, corrections  321..512 (8)
//   kFullSmem     C (k, k) tiles                   -                    <= 240 (1..8)
//   kFullRing     -                                tile entries         241..512 (8)
//
// A streamed entry goes through a per-lane ring of D steps filled by
// cp.async (each lane reads only what it copied, so no barrier either),
// re-read every sweep: a_full from L2 (shared by all blocks), the tiles
// and corrections at 4 bytes a lane, whose 32-byte sectors the block's
// neighbouring columns share (n k^2 4 bytes a sweep through L2: the tile
// entry past k = 240 is slower than the parent's lane-per-column stream).
// The masked half-updates run kPackedSmem at k = 50 and 100: 4 blocks of
// 4 warps an SM at k = 50 (51 KB each), one of 8 at k = 100.
//
// Arithmetic is written with the _rn intrinsics so that nvcc contracts
// nothing into FMAs: each step rounds exactly like the plain version's
// separate elementwise kernels. The sweep tolerance is summed in the
// parent's order (its partials over coordinates i = w mod G, in step order,
// then over w in order; G = 8 for k <= 224, 16 above), so the outputs equal
// the parent's bit for bit. Build WITHOUT --use_fast_math: the clamp term
// x_i / 1e-15 and the tol / k <= 1e-8 exit need IEEE division and
// denormals kept.
//
// Ranks above 512: nnls_wide.cu (`nnls_wide_b2`, `nnls_wide_b2_packed`),
// whose note is in nnls_wide.cuh; this source takes `cd_clamp` from
// there.
//
// The counters, as in nnls_cd.cu: given a (sweeps, columns) pair, lane 0
// of each column whose mask lets it move adds the sweeps it ran, and 1,
// each warp with one atomicAdd each (`count_cd`, nnls_wide.cuh), in
// instantiations of their own (COUNT) that only a launch with a counter
// runs.

#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "nnls_wide.cuh"

namespace {

constexpr int kLanes = 32;
constexpr int kMaxCols = 8;                 // columns of a block
constexpr unsigned kFullMask = 0xffffffffu;
constexpr float kCdTol = 1e-8f;             // CD_TOL of ops/nnls.py
constexpr size_t kSmemMax = 232448;         // a Hopper block's shared memory
constexpr int kAnySlot = -1;                // see `fetch` below

// f(integral_constant<int, I>) for I in [B, E): loop indices that
// `if constexpr` can read
template <int B, int E, class F>
__device__ __forceinline__ void static_for(F&& f) {
  if constexpr (B < E) {
    f(std::integral_constant<int, B>{});
    static_for<B + 1, E>(f);
  }
}

enum Mode : int {
  kPackedSmem = 0,
  kPackedRingA = 1,
  kPackedRing = 2,
  kFullSmem = 3,
  kFullRing = 4,
};

__host__ __device__ constexpr bool packed_mode(int m) {
  return m <= kPackedRing;
}

// arrays per ring slot and lane: a_full, a_full and corrections, or tiles
__host__ __device__ constexpr int ring_arrays(int m) {
  return m == kPackedRing ? 2 : (m == kPackedRingA || m == kFullRing) ? 1
                                                                        : 0;
}

__host__ __device__ constexpr int ring_depth(int m) {
  return m == kPackedRing ? 4 : 8;
}

__host__ __device__ constexpr bool columns_in_smem(int m) {
  return m == kPackedSmem || m == kPackedRingA || m == kFullSmem;
}

// the floats of one column's Gram held in shared memory
__host__ __device__ constexpr size_t column_floats(int m, int k) {
  return packed_mode(m) ? (size_t)k * (k + 1) / 2 : (size_t)k * k;
}

// a column's stride in shared memory: its floats rounded up to 16 mod 32,
// so that the two half-warp columns of a warp read their rows at the same
// positions from disjoint banks
__host__ __device__ constexpr size_t column_pitch(int m, int k) {
  return column_floats(m, k) + ((16 - column_floats(m, k)) & 31);
}

struct Layout {    // offsets in 4-byte words of dynamic shared memory
  size_t rs, a, cols, ring, total;
};

// the row starts, a_full, the columns (with `span` words of slack after
// them: lanes past k read there instead of branching), the rings; span =
// W NPT, the coordinates a column's lanes cover
__host__ __device__ inline Layout make_layout(int m, int k, int cols,
                                              int span) {
  Layout L{};
  size_t off = 0;
  L.rs = off;
  if (packed_mode(m)) off += ((size_t)k + 3) & ~(size_t)3;
  L.a = off;
  if (m == kPackedSmem) off += ((size_t)k * k + 3) & ~(size_t)3;
  L.cols = off;
  if (columns_in_smem(m)) off += (size_t)cols * column_pitch(m, k) + span;
  off = (off + 3) & ~(size_t)3;
  L.ring = off;
  off += (size_t)cols * ring_depth(m) * ring_arrays(m) * span;
  L.total = off;
  return L;
}

// cp.async (sm_80+) of 4 or 16 bytes from device to shared memory, its
// group commit and wait. The "memory" clobbers keep the compiler from
// moving a read of a ring slot past the copy that refills it.
__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n"
               :: "r"(d), "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async16(float* dst, const float* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n"
               :: "r"(d), "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

struct Args {
  const float* gram;       // at (k, k, n) for the full modes, else a_full
  const float* packed_t;   // (npairs, n), packed modes
  const int* row_start;    // (k,), packed modes: pos(r, r)
  const float* inv_diag;   // (k, n), full modes
  const float* B;          // (n, k)
  const float* X0;         // (n, k)
  const uint8_t* mask;     // (n,) or null
  const float* l1;         // (n, k) per-coordinate L1, or null for L1
  float* X;                // (n, k)
  unsigned long long* counts;   // (sweeps, columns) to add to, or null
  int n, k, cols, groups, max_sweeps;
  float L1, L2, k_div, cap;
};

// Stage the block's columns of `src` ((rows, n), contiguous over columns)
// into shared memory, column c at dst + c pitch: with eight columns, 16-byte
// loads of four neighbouring columns, scattered into their columns; else
// 4-byte cp.async, neighbouring threads on neighbouring columns
__device__ __forceinline__ void stage_columns(float* dst, const float* src,
                                              int rows, size_t pitch, int n,
                                              int c0, int cols) {
  if (cols == kMaxCols && c0 + kMaxCols <= n && (n & 3) == 0 &&
      (reinterpret_cast<uintptr_t>(src) & 15) == 0) {
    const int h = threadIdx.x & 1;
    const float* s = src + c0 + 4 * h;
    float* d = dst + (size_t)(4 * h) * pitch;
#pragma unroll 8
    for (int r = threadIdx.x >> 1; r < rows; r += blockDim.x >> 1) {
      const float4 v =
          __ldg(reinterpret_cast<const float4*>(s + (size_t)r * n));
      d[r] = v.x;
      d[pitch + r] = v.y;
      d[2 * pitch + r] = v.z;
      d[3 * pitch + r] = v.w;
    }
    return;
  }
  const int ncols = min(cols, n - c0);
  for (int e = threadIdx.x; e < rows * ncols; e += blockDim.x) {
    const int r = e / ncols;
    const int c = e - r * ncols;
    cp_async4(dst + c * pitch + r, src + (size_t)r * n + c0 + c);
  }
}

// W lanes per column (16: two columns a warp, one per half, sharing the
// loads of a_full; 32: one), NPT coordinates per lane in registers
// (k <= W NPT); a block of C neighbouring columns; L1V: a per-coordinate
// L1 (p.l1, NPT more registers a lane), else the scalar p.L1; COUNT: add
// the columns' sweeps and the columns to p.counts
template <int M, int W, int NPT, bool L1V, bool COUNT>
__global__ void __launch_bounds__(W * kMaxCols,
                                  W == 16 || NPT <= 2 ? 4 : 1)
nnls_cd_col_kernel(const Args p) {
  constexpr int D = ring_depth(M);
  constexpr int E = ring_arrays(M) * NPT;
  constexpr bool kRing = ring_arrays(M) > 0;
  constexpr bool kPacked = packed_mode(M);
  // the corrections come from shared memory, at pos(s, j) for row s
  constexpr bool kColumnPos = M == kPackedSmem || M == kPackedRingA;
  static_assert(!kRing || W == kLanes, "the streamed modes take W = 32");
  extern __shared__ __align__(16) float smem[];
  const int k = p.k;
  const int n = p.n;
  const int c0 = blockIdx.x * p.cols;
  const Layout L = make_layout(M, k, p.cols, W * NPT);
  int* rs_s = reinterpret_cast<int*>(smem + L.rs);
  const float* a_s = smem + L.a;
  const size_t pitch = column_pitch(M, k);

  // stage the row starts, a_full and the block's columns; then the
  // block's only barrier
  if constexpr (kPacked) {
    for (int r = threadIdx.x; r < k; r += blockDim.x) {
      rs_s[r] = p.row_start[r];
    }
  }
  if constexpr (M == kPackedSmem) {
    const int total = k * k;
    int done = 0;
    if ((reinterpret_cast<uintptr_t>(p.gram) & 15) == 0) {
      done = total & ~3;
      for (int e = 4 * threadIdx.x; e < done; e += 4 * blockDim.x) {
        cp_async16(smem + L.a + e, p.gram + e);
      }
    }
    for (int e = done + threadIdx.x; e < total; e += blockDim.x) {
      cp_async4(smem + L.a + e, p.gram + e);
    }
  }
  if constexpr (columns_in_smem(M)) {
    stage_columns(smem + L.cols, kPacked ? p.packed_t : p.gram,
                  (int)column_floats(M, k), pitch, n, c0, p.cols);
  }
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();

  const int lane = threadIdx.x % W;   // the column's lane
  const int cw = threadIdx.x / W;     // the block's column
  const int col = c0 + cw;
  const bool valid = cw < p.cols && col < n;
  // the half-warp past an odd block's last column reads that column
  const float* col_s = smem + L.cols + min(cw, p.cols - 1) * pitch;
  float* ring = smem + L.ring + (size_t)cw * D * E * W + lane;
  // cleared when the column stops: its x is frozen, and its b no longer
  // read; the warp runs while one of its columns is active
  bool active = valid && (p.mask == nullptr || p.mask[col] != 0);
  const bool counted = COUNT && active && lane == 0;
  int ran = 0;   // sweeps the column ran (COUNT)
  const int rs0 = kPacked ? rs_s[0] : 0;

  // coordinate j = W q + lane of this column, in registers; lanes past k
  // hold zeros and are never owners
  float b[NPT], x[NPT], inv[NPT];
  float l1v[L1V ? NPT : 1];
  int lo[NPT];   // packed: pos(j, s) = lo + s for j < s
#pragma unroll
  for (int q = 0; q < NPT; ++q) {
    const int j = q * W + lane;
    const bool own = valid && j < k;
    b[q] = own ? p.B[(size_t)col * k + j] : 0.f;
    x[q] = own ? p.X0[(size_t)col * k + j] : 0.f;
    if constexpr (L1V) l1v[q] = own ? p.l1[(size_t)col * k + j] : 0.f;
    inv[q] = 0.f;
    lo[q] = kPacked && j < k ? rs_s[j] - j : 0;
    if (own && active) {
      if constexpr (kPacked) {
        // 1 / (a_full[j, j] - packed_t[pos(j, j), c]): the subtraction
        // and the correctly rounded reciprocal of 1 / unpack(...)[j, j]
        const int d = lo[q] + j;
        const float a = M == kPackedSmem ? a_s[j * k + j]
                                         : p.gram[(size_t)j * k + j];
        const float c = M == kPackedRing ? p.packed_t[(size_t)d * n + col]
                                         : col_s[d];
        inv[q] = __frcp_rn(__fsub_rn(a, c));
      } else {
        inv[q] = p.inv_diag[(size_t)j * n + col];
      }
    }
  }

  if (__any_sync(kFullMask, active)) {
    // up(s) = pos(s, s) - s, so pos(s, j) = up(s) + j for j >= s; the
    // triangle is row-major, pos(s + 1, s + 1) = pos(s, s) + k - s
    auto next_up = [&](int s, int up) {
      return s + 1 == k ? rs0 : up + (k - s - 1);
    };
    // the ring (W = 32): copies of step `fetch_step` go to slot
    // `fetch_slot`, D - 2 steps ahead of the step read; the slot refilled
    // is the one read two steps before, whose values have been used by
    // then. Lanes past k copy row k - 1's entry.
    int fetch_step = 0, fetch_slot = 0, read_slot = 0, fetch_up = rs0;
    auto issue = [&]() {
      const int s = fetch_step;
      float* dst = ring + (size_t)fetch_slot * E * W;
#pragma unroll
      for (int q = 0; q < NPT; ++q) {
        const int j = min(q * W + lane, k - 1);
        if constexpr (M == kFullRing) {
          cp_async4(dst + q * W, p.gram + ((size_t)s * k + j) * n + col);
        } else {
          cp_async4(dst + q * W, p.gram + (size_t)s * k + j);
          if constexpr (M == kPackedRing) {
            const int pos = j >= s ? fetch_up + j : lo[q] + s;
            cp_async4(dst + (NPT + q) * W,
                      p.packed_t + (size_t)pos * n + col);
          }
        }
      }
      cp_async_commit();
      if constexpr (M == kPackedRing) fetch_up = next_up(s, fetch_up);
      fetch_step = fetch_step + 1 == k ? 0 : fetch_step + 1;
      fetch_slot = (fetch_slot + 1) & (D - 1);
    };
    // the raw entries of step s for this lane's coordinates: av the tile's
    // or a_full's, cv the correction's. qs: the slot of s where it is known
    // when compiling (a slot's inner steps; the ring's current step), so
    // that only that slot's lanes choose between the triangle's row s
    // (j >= s, at up + j) and its column s (j < s, at lo + s); kAnySlot
    // where every slot chooses.
    auto fetch = [&](auto qs, int s, int up, float (&av)[NPT],
                     float (&cv)[NPT]) {
      constexpr int QS = decltype(qs)::value;
      const float* slot = ring;
      if constexpr (kRing) {
        issue();
        cp_async_wait<D - 2>();
        slot = ring + (size_t)read_slot * E * W;
        read_slot = (read_slot + 1) & (D - 1);
      }
      static_for<0, NPT>([&](auto tc) {
        constexpr int t = decltype(tc)::value;
        const int j = t * W + lane;
        if constexpr (M == kFullSmem) {
          av[t] = col_s[s * k + j];
        } else if constexpr (kRing) {
          av[t] = slot[t * W];
        } else {
          av[t] = a_s[s * k + j];
        }
        if constexpr (M == kPackedRing) {
          cv[t] = slot[(NPT + t) * W];
        } else if constexpr (kColumnPos) {
          if constexpr (QS != kAnySlot && t < QS) {
            cv[t] = col_s[lo[t] + s];
          } else if constexpr (QS != kAnySlot && t > QS) {
            cv[t] = col_s[up + j];
          } else {
            cv[t] = col_s[j >= s ? up + j : lo[t] + s];
          }
        }
      });
    };
    // one step of owner slot q. The downdate by the previous step's delta
    // (d_prev, with its entries g_prev) is applied in two parts: first to
    // slot q, whose b the owner's diff reads, then, once this step's delta
    // is on its way through the shuffle, to the other slots: each b_j
    // still takes the deltas in step order, and the chain from one delta
    // to the next holds only the owner's slot. From shared memory the
    // entries were fetched two steps before into av, cv, which then take
    // those of step i + 2 (in slot q for the inner steps; else qs is
    // kAnySlot); from the ring, at the step.
    int up_f = rs0;   // up of the step fetched next
    float g_prev[NPT], d_prev = 0.f;
#pragma unroll
    for (int t = 0; t < NPT; ++t) g_prev[t] = 0.f;
    auto step = [&](auto qc, auto qs, int l, float (&av)[NPT],
                    float (&cv)[NPT]) {
      constexpr int q = decltype(qc)::value;
      constexpr bool kInner = decltype(qs)::value != kAnySlot;
      const int i = q * W + l;
      b[q] = __fsub_rn(b[q], __fmul_rn(g_prev[q], d_prev));
      const float x_i = x[q];
      float l1_q = p.L1;
      if constexpr (L1V) l1_q = l1v[q];
      const float diff = __fadd_rn(
          __fsub_rn(__fmul_rn(b[q], inv[q]), l1_q), __fmul_rn(p.L2, x_i));
      const float delta = __shfl_sync(kFullMask, cd_clamp(diff, -x_i), l, W);
      if (lane == l && active) x[q] = __fadd_rn(x_i, delta);
#pragma unroll
      for (int t = 0; t < NPT; ++t) {
        if (t != q) b[t] = __fsub_rn(b[t], __fmul_rn(g_prev[t], d_prev));
      }
      if constexpr (kRing) {
        fetch(qc, i, up_f, av, cv);
        if constexpr (kColumnPos) up_f = next_up(i, up_f);
      }
#pragma unroll
      for (int t = 0; t < NPT; ++t) {
        g_prev[t] = kPacked ? __fsub_rn(av[t], cv[t]) : av[t];
      }
      d_prev = delta;
      if constexpr (!kRing) {
        int i2 = i + 2;   // an inner step's is in slot q, below k
        if constexpr (!kInner) {
          if (i2 >= k) i2 -= k;
          if (i2 >= k) i2 -= k;   // k = 1
        }
        fetch(qs, i2, up_f, av, cv);
        if constexpr (kColumnPos) up_f = next_up(i2, up_f);
      }
    };

    if constexpr (kRing) {
      for (int t = 0; t < D - 2; ++t) issue();
    }
    // even steps' entries in (a0, c0v), odd steps' in (a1, c1v)
    float a0[NPT], c0v[NPT], a1[NPT], c1v[NPT];
    constexpr std::integral_constant<int, kAnySlot> any_slot{};
    if constexpr (!kRing) {
      fetch(any_slot, 0, up_f, a0, c0v);
      if constexpr (kColumnPos) up_f = next_up(0, up_f);
      fetch(any_slot, 1 % k, up_f, a1, c1v);
      if constexpr (kColumnPos) up_f = next_up(1 % k, up_f);
    }
    for (int sweep = 1;; ++sweep) {
      float part = 0.f;   // lanes < G: the parent's tol partial of warp lane
      static_for<0, NPT>([&](auto qc) {
        constexpr int q = decltype(qc)::value;
        const float x_start = x[q];
        const int steps = min(W, k - q * W);
        if constexpr (kRing) {
#pragma unroll 1
          for (int l = 0; l < steps; ++l) step(qc, qc, l, a0, c0v);
        } else if (steps > 0) {
          // two steps an iteration; a step fetches step + 2, within slot q
          // for the inner steps, past it for the last two
          int l = 0;
          for (; l + 3 < steps; l += 2) {
            step(qc, qc, l, a0, c0v);
            step(qc, qc, l + 1, a1, c1v);
          }
          if (steps - l == 3) {
            step(qc, qc, l, a0, c0v);
            step(qc, any_slot, l + 1, a1, c1v);
            step(qc, any_slot, l + 2, a0, c0v);
          } else if (steps - l == 2) {
            step(qc, any_slot, l, a0, c0v);
            step(qc, any_slot, l + 1, a1, c1v);
          } else {
            step(qc, any_slot, l, a0, c0v);
          }
          if (steps & 1) {
            // the next slot starts at an even step in the odd buffers
#pragma unroll
            for (int t = 0; t < NPT; ++t) {
              const float a = a0[t], c = c0v[t];
              a0[t] = a1[t];
              c0v[t] = c1v[t];
              a1[t] = a;
              c1v[t] = c;
            }
          }
        }
        // this slot's tol terms, added to the partial of group i mod G in
        // the parent's order: i = W q + w, + G, ... for lane w < G
        float term = 0.f;
        if (q * W + lane < k) {
          term = __fdiv_rn(fabsf(__fsub_rn(x[q], x_start)),
                           __fadd_rn(x[q], 1e-15f));
        }
        part = __fadd_rn(part, term);
        for (int off = p.groups; off < W; off += p.groups) {
          part = __fadd_rn(part, __shfl_down_sync(kFullMask, term, off, W));
        }
      });
      float total = 0.f;
      for (int v = 0; v < p.groups; ++v) {
        total = __fadd_rn(total, __shfl_sync(kFullMask, part, v, W));
      }
      if (COUNT && active) ran = sweep;
      if (!(__fdiv_rn(total, p.k_div) > kCdTol) || sweep >= p.max_sweeps ||
          !((float)sweep < p.cap)) {
        active = false;
      }
      if (!__any_sync(kFullMask, active)) break;
    }
    if constexpr (kRing) {
      cp_async_wait<0>();   // no copy may land after the warp retires
    }
  }

  if (valid) {
#pragma unroll
    for (int q = 0; q < NPT; ++q) {
      const int j = q * W + lane;
      if (j < k) p.X[(size_t)col * k + j] = x[q];
    }
  }
  if constexpr (COUNT) count_cd(p.counts, counted ? ran : 0, counted);
}

// coordinates per lane: the instantiated NPT of the fewest slots of W
// lanes with k <= W NPT (every lane runs every slot, so NPT follows k)
constexpr int kNpts16[] = {1, 2, 3, 4, 5, 7};
constexpr int kNpts32[] = {1, 2, 3, 4, 6, 8, 10, 12, 16};
// half a warp per column up to these k (the tile entry; the packed one),
// past them a warp per column
constexpr int kMaxK16 = 16 * 7;
constexpr int kMaxK16Packed = 16 * 4;

template <int W>
constexpr int npt_count() {
  return W == 16 ? (int)(sizeof(kNpts16) / sizeof(int))
                 : (int)(sizeof(kNpts32) / sizeof(int));
}

template <int W>
constexpr int npt_at(int i) {
  return W == 16 ? kNpts16[i] : kNpts32[i];
}

template <int W>
int npt_of(int k) {
  for (int i = 0; i < npt_count<W>(); ++i) {
    if (k <= W * npt_at<W>(i)) return npt_at<W>(i);
  }
  return 0;
}

// lanes per column
int lanes_of(int m, int k) {
  if (m == kPackedSmem) return k <= kMaxK16Packed ? 16 : 32;
  return m == kFullSmem && k <= kMaxK16 ? 16 : 32;
}

// the coordinates a column's lanes cover, W NPT
int span_of(int m, int k) {
  return lanes_of(m, k) == 16 ? 16 * npt_of<16>(k) : 32 * npt_of<32>(k);
}

// the most columns (<= 8) whose block fits in shared memory, or 0
int fit_cols(int m, int k) {
  for (int c = kMaxCols; c >= 1; --c) {
    if (make_layout(m, k, c, span_of(m, k)).total * sizeof(float) <=
        kSmemMax) {
      return c;
    }
  }
  return 0;
}

template <int M, int W, int NPT, bool L1V, bool COUNT>
cudaError_t launch(Args p, int cols, cudaStream_t stream) {
  const size_t smem =
      make_layout(M, p.k, cols, W * NPT).total * sizeof(float);
  if (cols < 1 || smem > kSmemMax) return cudaErrorInvalidValue;
  auto kernel = nnls_cd_col_kernel<M, W, NPT, L1V, COUNT>;
  static bool configured = false;   // per instantiation, on first launch
  if (!configured) {
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)kSmemMax);
    if (err != cudaSuccess) return err;
    err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
        cudaSharedmemCarveoutMaxShared);
    if (err != cudaSuccess) return err;
    configured = true;
  }
  p.cols = cols;
  const int blocks = (p.n + cols - 1) / cols;
  const int threads = (cols * W + kLanes - 1) / kLanes * kLanes;
  kernel<<<blocks, threads, smem, stream>>>(p);
  return cudaGetLastError();
}

// the (mode, W, NPT) that the choice below takes for some k <= 512
template <int M, int W>
constexpr bool instantiated(int npt) {
  if (M == kPackedSmem) return W == 16 ? npt <= 4 : npt >= 3 && npt <= 4;
  if (W == 16) return M == kFullSmem;                         // k <= 112
  switch (M) {
    case kFullSmem: return npt >= 4 && npt <= 8;              // 113..238
    case kPackedRingA: return npt >= 4 && npt <= 10;          // 108..320
    case kPackedRing: return npt >= 12;                       // 321..512
    case kFullRing: return npt >= 8;                          // 239..512
    default: return false;
  }
}

template <int M, int W, int I = 0>
cudaError_t launch_npt(const Args& p, int cols, int npt, cudaStream_t s) {
  if constexpr (I < npt_count<W>()) {
    constexpr int NPT = npt_at<W>(I);
    if (npt == NPT) {
      if constexpr (instantiated<M, W>(NPT)) {
        if (p.counts != nullptr) {
          return p.l1 != nullptr ? launch<M, W, NPT, true, true>(p, cols, s)
                                 : launch<M, W, NPT, false, true>(p, cols, s);
        }
        return p.l1 != nullptr ? launch<M, W, NPT, true, false>(p, cols, s)
                               : launch<M, W, NPT, false, false>(p, cols, s);
      }
      return cudaErrorNotSupported;
    }
    return launch_npt<M, W, I + 1>(p, cols, npt, s);
  }
  return cudaErrorNotSupported;
}

template <int M>
cudaError_t launch_mode(const Args& p, int cols, cudaStream_t s) {
  if (lanes_of(M, p.k) == 16) {
    return launch_npt<M, 16>(p, cols, npt_of<16>(p.k), s);
  }
  return launch_npt<M, 32>(p, cols, npt_of<32>(p.k), s);
}

Args make_args(const float* B, const float* X0, const uint8_t* mask,
               const float* l1, float* X, int n, int k, float L1, float L2,
               float k_div, float cap, int max_sweeps,
               unsigned long long* counts) {
  Args p{};
  p.counts = counts;
  p.B = B;
  p.X0 = X0;
  p.mask = mask;
  p.l1 = l1;
  p.X = X;
  p.n = n;
  p.k = k;
  p.groups = k <= 224 ? 8 : 16;   // the parent's warps, for the tol order
  p.max_sweeps = max_sweeps;
  p.L1 = L1;
  p.L2 = L2;
  p.k_div = k_div;
  p.cap = cap;
  return p;
}

}  // namespace

extern "C" {

// All pointers are device pointers to contiguous float32 (mask: uint8, or
// null for all columns active); at (k, k, n) with at[i, j, c] = a_c[j, i],
// inv_diag (k, n), B / X0 / X (n, k), l1 (n, k) per-coordinate L1 or null
// for the scalar L1 (each is its own instantiation: the scalar one's code
// is that of a kernel without l1); counts null, or two uint64 that the
// call adds its columns' sweeps and its columns to. Takes k <= 512 (past
// it the wrapper calls nnls_wide_b2). Returns the cudaError_t of the
// launch (0 on success).
int nnls_cd_batched(const float* at, const float* inv_diag, const float* B,
                    const float* X0, const uint8_t* mask, const float* l1,
                    float* X, int n, int k, float L1, float L2, float k_div,
                    float cap, int max_sweeps, unsigned long long* counts,
                    void* stream) {
  if (n <= 0) return cudaSuccess;
  if (k <= 0 || k > 512) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  Args p = make_args(B, X0, mask, l1, X, n, k, L1, L2, k_div, cap,
                     max_sweeps, counts);
  p.gram = at;
  p.inv_diag = inv_diag;
  const int cols = fit_cols(kFullSmem, k);
  if (cols >= 1) return launch_mode<kFullSmem>(p, cols, s);
  return launch_mode<kFullRing>(p, fit_cols(kFullRing, k), s);
}

// The packed entry: a_full (k, k), packed_t (k (k + 1) / 2, n) and
// row_start (k,) int32 of the row-major upper triangle, pos(r, j >= r) =
// row_start[r] + j - r and row_start[r + 1] = row_start[r] + k - r, in
// place of at and inv_diag; a_c[j, i] = a_full[i, j] - packed_t[pos(i, j), c], and
// 1 / a_c[i, i] is formed here. The other arguments as above.
int nnls_cd_batched_packed(const float* a_full, const float* packed_t,
                           const int* row_start, const float* B,
                           const float* X0, const uint8_t* mask,
                           const float* l1, float* X, int n, int k,
                           float L1, float L2, float k_div, float cap,
                           int max_sweeps, unsigned long long* counts,
                           void* stream) {
  if (n <= 0) return cudaSuccess;
  if (k <= 0 || k > 512) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  Args p = make_args(B, X0, mask, l1, X, n, k, L1, L2, k_div, cap,
                     max_sweeps, counts);
  p.gram = a_full;
  p.packed_t = packed_t;
  p.row_start = row_start;
  if (fit_cols(kPackedSmem, k) == kMaxCols) {
    return launch_mode<kPackedSmem>(p, kMaxCols, s);
  }
  const int cols = fit_cols(kPackedRingA, k);
  if (k <= 320 && cols >= 1) return launch_mode<kPackedRingA>(p, cols, s);
  return launch_mode<kPackedRing>(p, fit_cols(kPackedRing, k), s);
}

const char* nnls_cd_batched_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"

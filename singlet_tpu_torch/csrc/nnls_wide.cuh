// The wide-k route of kernels B1 and B2 (k > 512); nnls_wide.cu holds
// its entries, nnls_cd.cu and nnls_cd_batched.cu take `cd_clamp` from here.
//
// B1 and B2 hold a column's coordinates in registers, at most 16 a lane,
// so their tuned routes end at k = 512. Past it, three kernels:
//
// `staged_kernel` (B2, and B1 where its quad ring does not fit;
// ops/nnls_cuda.py `nnls_wide_plan` with a depth; `quad_kernel` below is
// B1's form of it): a block takes C = 8, 4, 2 or 1 neighbouring columns
// that sweep in lockstep, P = 32, 64, 128 or 256 threads a column (C P <=
// 256), so that a thread holds at most 64 of a column's coordinates.
// Thread (l, c) = (tid / C, tid % C) holds coordinates l, l + P, ... of
// column c: their residual b (the gradient the CD steps downdate) in
// registers, x in shared memory. The Gram entries step i needs, a_c[t, i]
// for every t, do not depend on x, so the block copies them (`cp.async`,
// 16 or 8 bytes where the rows allow it) into a ring of D slots in shared
// memory, D - 2 steps ahead of the chain, and the chain reads only shared
// memory:
//
//   B2 (`TileGram`, `PackedGram`): C consecutive floats of row (i, t) of
//     the tiles, or of the packed corrections at pos(i, t) beside a_full's
//     row i: whole sectors (or parts), where the old route read one float
//     of a sector a column;
//   B1 (`SharedGram`, `quad_kernel`): row i of the transposed Gram, k
//     floats shared by every column of the block, so a block reads the
//     Gram from L2 once for C columns; thread (l, c) holds coordinates
//     4 l + e + 4 P v, so that one thread owns four consecutive steps and
//     takes them by itself, the block meeting once every four steps, and
//     each thread reads the staged row 16 bytes at a time. Its ring holds
//     12 or 16 rows; where they do not fit beside x (k > about 2,900 at
//     four columns a block), B1 runs `staged_kernel` on the Gram's rows.
//
// Step g of the block: issue the copy of the slab of step g + D - 2; each
// live column's threads downdate their coordinates by the previous step's
// delta (b_t -= a_c[t, i - 1] delta), the owner thread (i mod P, c)
// first its own coordinate i (kept beside b, so that it need not index b
// at run time); the owner then computes
//
//   diff  = b_i * inv_i - L1_i + L2 * x_i,  delta = max(diff, -x_i)
//                                          (a NaN kept, `cd_clamp`)
//   x_i  += delta
//
// writes delta to shared memory, and the block waits for the slab of step
// g + 1 and meets at one barrier. 1/diag and the (n, k) L1 of the owner's
// next coordinate are loaded a window of P steps ahead. The sweep terms
// |x_i - x_start| / (x_i + 1e-15), off the chain, are summed at the
// sweep's end from x and the x_start each owner kept: each of the first
// 32 threads of a column its steps i = l mod 32 in step order, the
// column's 32 partials as the xor butterfly 16, 8, 4, 2, 1 sums the
// lanes'. A column that stops takes no more steps; the block runs until
// its last column stops. Every b_t is downdated in step order with the
// same _rn operations as the old route's and the tol is summed in its
// order, so the bits are `wide_kernel`'s, NaN for NaN, whatever C and P.
//
// `wide_kernel` (past the staged kernels' reach: k > 6,452 for B2, whose
// packed slab and row starts then leave no ring of 3 slots beside one
// column's x and x_start, k > 11,612 for B1; and the device-scratch route
// past k = 29,056): a warp a column, x and b in shared memory (8 k bytes
// a column, as many columns a block as fit, 8 at most), or in a scratch
// buffer in device memory that the caller allocates. Lane l owns
// coordinates l, l + 32, ...; the owner lane of step i computes delta as
// above, broadcasts it by shuffle, and every lane downdates its
// coordinates with the Gram's column i read from device memory (the GRAM
// accessor's `entry`), 8 entries a lane loaded before any is used. Its
// steps wait on trips to L2 or device memory; it was the route of every k
// > 512 before the staged kernel (nnls_wide_warp.cu keeps that route's
// source as it was, for timing the two in turns) and of every k > 2048
// before the staged kernels took more threads a column.
//
// Every step rounds as the plain version does (the _rn intrinsics, no
// contraction into FMAs).
//
// What bounds the staged kernels: B2 reads every packed correction twice a
// sweep (as (i, t) and as (t, i)), 738 MB a sweep at 512 columns of k =
// 600 and 13.4 GB at k = 2,560, in 8- to 32-byte pieces scattered over
// device memory (a floor of about 0.22 and 4.0 ms a sweep at 3.35 TB/s;
// scattered pieces move at a fraction of it). B1's Gram sits in L2 to k =
// 3,600; its floor is the downdates, n k^2 multiply-adds a sweep (at k =
// 2,560 and 2,048 columns 0.4 ms a sweep at 67 TFLOP/s), and the chain: k
// dependent steps a sweep, each six dependent float operations of the
// owner and, every four steps, a barrier and a shared-memory load of the
// deltas. More threads a column keep the downdates of a wide column on as
// many warps as at k <= 2,048.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

// max(diff, -x_i) of the CD step, as torch.maximum and jnp.maximum take
// it: a NaN in either operand gives NaN (PTX max.NaN, sm_80+). fmaxf
// would return the other operand, so a zero Gram diagonal (1/diag inf,
// b_i * inf NaN) would clamp x_i to 0 where the plain version's column
// turns NaN. Wherever neither operand is NaN it equals fmaxf, bit for bit.
__device__ __forceinline__ float cd_clamp(float diff, float neg_x) {
  float r;
  asm("max.NaN.f32 %0, %1, %2;" : "=f"(r) : "f"(diff), "f"(neg_x));
  return r;
}

// Add a warp's CD-NNLS counts to counts[0] (sweeps) and counts[1]
// (columns): the lanes' sums, reduced over the warp, one atomicAdd each
// from lane 0. Every lane of the warp calls it.
__device__ __forceinline__ void count_cd(unsigned long long* counts,
                                         unsigned sweeps, unsigned cols) {
  sweeps = __reduce_add_sync(0xffffffffu, sweeps);
  cols = __reduce_add_sync(0xffffffffu, cols);
  if ((threadIdx.x & 31) == 0 && cols != 0) {
    atomicAdd(counts, (unsigned long long)sweeps);
    atomicAdd(counts + 1, (unsigned long long)cols);
  }
}

namespace nnls_wide {

constexpr unsigned kFull = 0xffffffffu;
constexpr float kCdTol = 1e-8f;        // CD_TOL of ops/nnls.py
constexpr int kMaxWarps = 8;           // columns a block
constexpr int kMaxThreads = 256;       // threads a block of the staged
                                       // kernels, C P
constexpr int kBatch = 8;              // Gram entries a lane loads at once
constexpr size_t kSmemMax = 232448;    // a Hopper block's shared memory
constexpr int kMaxDepth = 8;           // ring slots of the staged kernel
constexpr int kMaxU = 64;              // b in registers: 64 a thread

struct Args {
  const float* B;         // (n, k)
  const float* X0;        // (n, k)
  const uint8_t* mask;    // (n,) or null
  const float* l1;        // (n, k) per-coordinate L1, or null for L1
  float* X;               // (n, k)
  float* scratch;         // device-memory state: 2 k floats a warp slot of
                          // the grid, or null for shared memory
  unsigned long long* counts;   // (sweeps, columns) to add to, or null
  int n, k, max_sweeps;
  int warps;              // columns a block
  int depth;              // ring slots of the staged kernel, 0 otherwise
  int lanes;              // threads a column of the staged kernels (P)
  float L1, L2, k_div, cap;
};

__host__ __device__ inline int round4(int x) { return (x + 3) & ~3; }

// the staged kernel's dynamic shared memory, floats: the ring (depth
// slabs), x and each step's x_start (C k each), the sweep-term sums (C
// rows of 33), delta (2 C) and, for the packed entry, the row starts (k
// ints)
__host__ __device__ inline size_t staged_floats(int k, int C, int depth,
                                                int slab, bool row_starts) {
  return (size_t)depth * slab + 2 * round4(C * k) + round4(33 * C) +
         round4(2 * C) + (row_starts ? round4(k) : 0);
}

// --------------------------------------------------------------- copies

// BYTES (4, 8 or 16) from global to shared memory: 16 bytes bypassing L1
// (.cg), 4 or 8 through it (.ca)
template <int BYTES>
__device__ __forceinline__ void copy_async(float* dst, const float* src) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  if constexpr (BYTES == 16) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n"
                 :: "r"(d), "l"(src) : "memory");
  } else if constexpr (BYTES == 8) {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n"
                 :: "r"(d), "l"(src) : "memory");
  } else {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n"
                 :: "r"(d), "l"(src) : "memory");
  }
}

__device__ __forceinline__ void copy_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void copy_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

// wait until at most `pending` of this thread's copy groups are in flight
__device__ __forceinline__ void copy_wait_upto(int pending) {
  switch (pending) {
    case 1: copy_wait<1>(); break;
    case 2: copy_wait<2>(); break;
    case 3: copy_wait<3>(); break;
    case 4: copy_wait<4>(); break;
    case 5: copy_wait<5>(); break;
    case 6: copy_wait<6>(); break;
    default: copy_wait<0>(); break;
  }
}

__device__ __forceinline__ int log2_of(int pow2) { return __ffs(pow2) - 1; }

// C floats (1, 2, 4 or 8) of each of k rows, row t at src(t) + c0, into
// slot[t C ...]: `vec` floats at a time at most (4 where n % 4 == 0 and
// the base is 16-byte aligned, 2 where n is even and it is 8-byte
// aligned, else 1), so that a piece is wholly in or out of range; the
// columns past n are not read
template <class ROW>
__device__ __forceinline__ void stage_rows(float* slot, int k, int C,
                                           long long c0, int n, int vec,
                                           const ROW& src, int tid,
                                           int nt) {
  if (vec == 4 && C >= 4) {
    const int half = C >> 3;            // C = 8: two chunks a row
    for (int j = tid; j < k * (C >> 2); j += nt) {
      const int t = j >> half;
      const int q = (j & half) << 2;
      if (c0 + q < n) copy_async<16>(slot + t * C + q, src(t) + c0 + q);
    }
  } else if (vec >= 2 && C >= 2) {
    const int sh = log2_of(C >> 1);     // 8-byte pieces a row, as a shift
    for (int j = tid; j < (k << sh); j += nt) {
      const int t = j >> sh;
      const int q = (j & ((1 << sh) - 1)) << 1;
      if (c0 + q < n) copy_async<8>(slot + t * C + q, src(t) + c0 + q);
    }
  } else {
    const int sh = log2_of(C);
    for (int j = tid; j < (k << sh); j += nt) {
      const int t = j >> sh;
      const int c = j & (C - 1);
      if (c0 + c < n) copy_async<4>(slot + t * C + c, src(t) + c0 + c);
    }
  }
}

// a row of kp = round4(k) floats, 16-byte aligned
__device__ __forceinline__ void stage_row(float* dst, const float* row,
                                          int kp, int tid, int nt) {
  for (int j = tid; j < (kp >> 2); j += nt) {
    copy_async<16>(dst + 4 * j, row + 4 * j);
  }
}

// ---------------------------------------------------------------- Grams
//
// Each GRAM gives wide_kernel `entry(col, i, t)` = a_col[t, i] and
// `inv(col, i)` = 1 / a_col[i, i] from device memory, both as the plain
// version rounds them; B2's give the staged kernel `slab(C)` (floats a
// ring slot, a multiple of 4), `stage` (the copies of step s's slab),
// `at` (a_c[t, s] from the slab), `diag` (what 1/diag is formed from,
// loaded from device memory) and `inv_of`; B1's the quad kernel its own.

// B1: one (k, k) Gram for every column, transposed (row i holds column i
// of a) in rows of kp = round4(k) floats
struct SharedGram {
  static constexpr bool kRowStarts = false;
  const float* aT;
  int k, kp;
  __device__ __forceinline__ float entry(long long, int i, int t) const {
    return __ldg(aT + (size_t)i * kp + t);
  }
  __device__ __forceinline__ float inv(long long, int i) const {
    return __frcp_rn(__ldg(aT + (size_t)i * kp + i));
  }
  // the quad kernel's: step s's row into a ring slot, and a diagonal entry
  __device__ __forceinline__ void stage(float* slot, int s, int tid,
                                        int nt) const {
    stage_row(slot, aT + (size_t)s * kp, kp, tid, nt);
  }
  __device__ __forceinline__ float diag(int t) const {
    return __ldg(aT + (size_t)t * kp + t);
  }
  // staged_kernel's, where the quad ring does not fit: a slot is step
  // s's row, read by every column of the block
  __host__ __device__ int slab(int) const { return kp; }
  __device__ __forceinline__ void stage(float* slot, int s, long long, int,
                                        const int*, int tid, int nt) const {
    stage(slot, s, tid, nt);
  }
  __device__ __forceinline__ float at(const float* slot, int t, int,
                                      int) const {
    return slot[t];
  }
  __device__ __forceinline__ float2 diag(long long, int t,
                                         const int*) const {
    return make_float2(diag(t), 0.f);
  }
  __device__ __forceinline__ float inv_of(float2 d) const {
    return __frcp_rn(d.x);
  }
};

// B2's tile entry: the tiles at (k, k, n), at[i, t, c] = a_c[t, i], with
// 1/diag (k, n) from the wrapper
struct TileGram {
  static constexpr bool kRowStarts = false;
  const float* at_;
  const float* inv_diag;
  int n, k;
  int vec;     // floats a copy the rows allow (stage_rows)
  __device__ __forceinline__ float entry(long long c, int i, int t) const {
    return __ldg(at_ + ((size_t)i * k + t) * n + c);
  }
  __device__ __forceinline__ float inv(long long c, int i) const {
    return __ldg(inv_diag + (size_t)i * n + c);
  }
  __host__ __device__ int slab(int C) const { return k * C; }
  __device__ __forceinline__ void stage(float* slot, int s, long long c0,
                                        int C, const int*, int tid,
                                        int nt) const {
    const float* base = at_ + (size_t)s * k * n;
    const int nn = n;
    stage_rows(slot, k, C, c0, n, vec,
               [base, nn](int t) { return base + (size_t)t * nn; }, tid, nt);
  }
  __device__ __forceinline__ float at(const float* slot, int t, int c,
                                      int C) const {
    return slot[t * C + c];
  }
  __device__ __forceinline__ float2 diag(long long c, int t,
                                         const int*) const {
    return make_float2(__ldg(inv_diag + (size_t)t * n + c), 0.f);
  }
  __device__ __forceinline__ float inv_of(float2 d) const { return d.x; }
};

// B2's packed entry: a_c[t, i] = a_full[i, t] - packed_t[pos(i, t), c],
// pos(r, j >= r) = row_start[r] + j - r, a_full in rows of kp =
// round4(k) floats; 1/diag formed as the tuned route forms it
struct PackedGram {
  static constexpr bool kRowStarts = true;
  const float* a_full;
  const float* packed_t;
  const int* row_start;
  int n, k, kp;
  int vec;     // floats a copy the rows allow (stage_rows)
  __device__ __forceinline__ float entry(long long c, int i, int t) const {
    const int lo = i < t ? i : t;
    const int pos = __ldg(row_start + lo) + (i < t ? t - i : i - t);
    return __fsub_rn(__ldg(a_full + (size_t)i * kp + t),
                     __ldg(packed_t + (size_t)pos * n + c));
  }
  __device__ __forceinline__ float inv(long long c, int i) const {
    const int pos = __ldg(row_start + i);
    return __frcp_rn(__fsub_rn(__ldg(a_full + (size_t)i * kp + i),
                               __ldg(packed_t + (size_t)pos * n + c)));
  }
  // the corrections (k rows of C) then a_full's row
  __host__ __device__ int slab(int C) const { return k * C + kp; }
  __device__ __forceinline__ void stage(float* slot, int s, long long c0,
                                        int C, const int* rs, int tid,
                                        int nt) const {
    const float* base = packed_t;
    const int nn = n;
    // t >= s: row s's run of pairs; t < s: pair (t, s) of row t
    stage_rows(slot, k, C, c0, n, vec,
               [base, nn, rs, s](int t) {
                 const int pos = t >= s ? rs[s] + (t - s) : rs[t] + (s - t);
                 return base + (size_t)pos * nn;
               },
               tid, nt);
    stage_row(slot + k * C, a_full + (size_t)s * kp, kp, tid, nt);
  }
  __device__ __forceinline__ float at(const float* slot, int t, int c,
                                      int C) const {
    return __fsub_rn(slot[k * C + t], slot[t * C + c]);
  }
  __device__ __forceinline__ float2 diag(long long c, int t,
                                         const int* rs) const {
    return make_float2(__ldg(a_full + (size_t)t * kp + t),
                       __ldg(packed_t + (size_t)rs[t] * n + c));
  }
  __device__ __forceinline__ float inv_of(float2 d) const {
    return __frcp_rn(__fsub_rn(d.x, d.y));
  }
};

// ------------------------------------------------------- staged kernel

// the counts of a counting staged kernel's block: the sweeps each active
// column ran, which `sweep_end` left in the spare 33rd float of its row
// of sums (so that no register holds them through the sweeps), read by
// thread c < C; warp 0 adds them (`count_cd`)
__device__ __forceinline__ void count_block(const Args& p, const float* ps,
                                            int tid, int C, bool active) {
  if (tid < 32) {
    const bool mine = tid < C && active;
    count_cd(p.counts, mine ? __float_as_int(ps[tid * 33 + 32]) : 0,
             mine ? 1 : 0);
  }
}

// the sweep's end of a staged kernel's column c: each of its first 32
// threads its terms |x_i - x_start| / (x_i + 1e-15) of steps i = l, l +
// 32, ... in step order, then the column's tol as the xor butterfly sums
// the 32 lanes' partials (lane 0's operand order); `live` goes false where
// the column stops, and, COUNT, thread tl = 0 leaves the sweep it stopped
// at in the row's spare float (`count_block`). Ends with the block's
// barrier before the partials are read.
template <bool COUNT>
__device__ __forceinline__ void sweep_end(const Args& p, bool& live,
                                          const float* xs, const float* x0s,
                                          float* ps, int c, int tl,
                                          int sweep) {
  if (live && tl < 32) {
    float part = 0.f;
    for (int t = tl; t < p.k; t += 32) {
      const float xn = xs[t];
      part = __fadd_rn(part, __fdiv_rn(fabsf(__fsub_rn(xn, x0s[t])),
                                       __fadd_rn(xn, 1e-15f)));
    }
    ps[c * 33 + tl] = part;
  }
  __syncthreads();
  if (live) {
    float s[16];
#pragma unroll
    for (int l = 0; l < 16; ++l) {
      s[l] = __fadd_rn(ps[c * 33 + l], ps[c * 33 + l + 16]);
    }
#pragma unroll
    for (int off = 8; off >= 1; off >>= 1) {
#pragma unroll
      for (int l = 0; l < off; ++l) s[l] = __fadd_rn(s[l], s[l + off]);
    }
    if (!(__fdiv_rn(s[0], p.k_div) > kCdTol) || sweep >= p.max_sweeps ||
        !((float)sweep < p.cap)) {
      live = false;
      if (COUNT && tl == 0) ps[c * 33 + 32] = __int_as_float(sweep);
    }
  }
}

// U: coordinates a thread, ceil(k / P) rounded up to an instantiated size;
// P: threads a column (p.lanes), a constant so that a thread's offsets
// fold into its loads
template <int U, int P, bool COUNT, class GRAM>
__global__ void __launch_bounds__(kMaxThreads)
staged_kernel(const Args p, const GRAM gram) {
  extern __shared__ __align__(16) float smem[];
  const int C = p.warps;
  const int k = p.k;
  const int D = p.depth;
  const int nt = C * P;
  const int tid = threadIdx.x;
  const int c = tid % C;
  const int tl = tid / C;
  const long long c0 = (long long)blockIdx.x * C;
  const long long col = c0 + c;
  const int slab = gram.slab(C);
  float* ring = smem;
  float* xs = ring + (size_t)D * slab + (size_t)c * k;   // x of column c
  float* x0s = xs + round4(C * k);                       // its x_start
  float* ps = ring + (size_t)D * slab + 2 * round4(C * k);  // C rows of 33
  float* dl = ps + round4(33 * C);                       // 2 C
  int* rs = reinterpret_cast<int*>(dl + round4(2 * C));  // k, packed only

  const bool in = col < p.n;
  const bool active = in && (p.mask == nullptr || p.mask[col] != 0);
  const size_t row = (size_t)(in ? col : 0) * k;
  for (int t = tl; t < k; t += P) {
    if (active) {
      xs[t] = p.X0[row + t];
    } else if (in) {
      p.X[row + t] = p.X0[row + t];
    }
  }
  bool live = active;
  if (!__syncthreads_or(live)) return;
  float b[U];
#pragma unroll
  for (int v = 0; v < U; ++v) {
    const int t = tl + P * v;
    b[v] = active && t < k ? p.B[row + t] : 0.f;
  }
  if constexpr (GRAM::kRowStarts) {
    for (int t = tid; t < k; t += nt) rs[t] = __ldg(gram.row_start + t);
    __syncthreads();
  }

  // the ring: the slab of block step g in slot g mod D, issued at step
  // g - (D - 2); the prologue issues steps 0 .. D - 3
  int s_issue = 0;       // step in the sweep of the next slab to issue
  for (int g = 0; g < D - 2; ++g) {
    gram.stage(ring + (size_t)g * slab, s_issue, c0, C, rs, tid, nt);
    copy_commit();
    s_issue = s_issue + 1 == k ? 0 : s_issue + 1;
  }
  int slot_issue = D - 2;
  int slot_prev = D - 1;

  const int windows = (k + P - 1) / P;
  // the owner's next coordinate: its 1/diag (raw) and L1, a window ahead
  float2 dnext = make_float2(0.f, 0.f);
  float l1next = p.L1;
  if (live && tl < k) {
    dnext = gram.diag(col, tl, rs);
    if (p.l1 != nullptr) l1next = __ldg(p.l1 + row + tl);
  }
  long long g = 0;       // the block's step
  for (int sweep = 1;; ++sweep) {
    for (int u = 0; u < windows; ++u) {
      // window u: steps P u .. P u + P - 1, thread l owns step P u + l
      const int to = tl + P * u;
      const bool own = live && to < k;
      float bo = 0.f;    // b[u], downdated beside it
#pragma unroll
      for (int v = 0; v < U; ++v) {
        if (v == u) bo = b[v];
      }
      const float inv_o = gram.inv_of(dnext);
      const float l1_o = l1next;
      const float x_o = own ? xs[to] : 0.f;
      if (own) x0s[to] = x_o;
      const float l2x_o = __fmul_rn(p.L2, x_o);
      const int tn = u + 1 < windows ? to + P : tl;
      if (live && tn < k) {
        dnext = gram.diag(col, tn, rs);
        if (p.l1 != nullptr) l1next = __ldg(p.l1 + row + tn);
      }
      const int steps = k - P * u < P ? k - P * u : P;
      for (int r = 0; r < steps; ++r, ++g) {
        gram.stage(ring + (size_t)slot_issue * slab, s_issue, c0, C, rs,
                   tid, nt);
        copy_commit();
        if (live && g > 0) {
          const float* prev = ring + (size_t)slot_prev * slab;
          const float d = dl[((g - 1) & 1) * C + c];
          if (to < k) bo = __fsub_rn(bo, __fmul_rn(gram.at(prev, to, c, C), d));
          if (own && r == tl) {
            const float diff =
                __fadd_rn(__fsub_rn(__fmul_rn(bo, inv_o), l1_o), l2x_o);
            const float dn = cd_clamp(diff, -x_o);
            dl[(g & 1) * C + c] = dn;
            xs[to] = __fadd_rn(x_o, dn);
          }
#pragma unroll
          for (int v = 0; v < U; ++v) {
            const int t = tl + P * v;
            if (t < k) {
              b[v] = __fsub_rn(b[v], __fmul_rn(gram.at(prev, t, c, C), d));
            }
          }
        } else if (own && r == tl) {   // the block's first step
          const float diff =
              __fadd_rn(__fsub_rn(__fmul_rn(bo, inv_o), l1_o), l2x_o);
          const float dn = cd_clamp(diff, -x_o);
          dl[(g & 1) * C + c] = dn;
          xs[to] = __fadd_rn(x_o, dn);
        }
        copy_wait_upto(D - 2);
        __syncthreads();
        slot_issue = slot_issue + 1 == D ? 0 : slot_issue + 1;
        slot_prev = slot_prev + 1 == D ? 0 : slot_prev + 1;
        s_issue = s_issue + 1 == k ? 0 : s_issue + 1;
      }
    }
    sweep_end<COUNT>(p, live, xs, x0s, ps, c, tl, sweep);
    if (!__syncthreads_or(live)) break;
  }
  copy_wait<0>();
  if (active) {
    for (int t = tl; t < k; t += P) p.X[row + t] = xs[t];
  }
  if constexpr (COUNT) count_block(p, ps, tid, C, active);
}

// ------------------------------------------------ the warp-a-column kernel

// GRAM: float entry(col, i, t) = a_col[t, i] and float inv(col, i) =
// 1 / a_col[i, i], both as the plain version rounds them
template <class GRAM, bool COUNT>
__global__ void __launch_bounds__(kMaxWarps * 32)
wide_kernel(const Args p, const GRAM gram) {
  extern __shared__ __align__(16) float smem[];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int k = p.k;
  const int slot = blockIdx.x * p.warps + warp;
  float* state = p.scratch != nullptr ? p.scratch + (size_t)slot * 2 * k
                                      : smem + (size_t)warp * 2 * k;
  float* x = state;
  float* b = state + k;
  for (long long col = slot; col < p.n;
       col += (long long)gridDim.x * p.warps) {
    const size_t row = (size_t)col * k;
    const bool active = p.mask == nullptr || p.mask[col] != 0;
    if (!active) {
      for (int t = lane; t < k; t += 32) p.X[row + t] = p.X0[row + t];
      continue;
    }
    for (int t = lane; t < k; t += 32) {
      x[t] = p.X0[row + t];
      b[t] = p.B[row + t];
    }
    for (int sweep = 1;; ++sweep) {
      float part = 0.f;   // this lane's terms, in step order
      for (int i = 0; i < k; ++i) {
        const int owner = i & 31;
        float d = 0.f;
        if (lane == owner) {
          const float xi = x[i];
          const float l1 = p.l1 == nullptr ? p.L1 : p.l1[row + i];
          const float diff =
              __fadd_rn(__fsub_rn(__fmul_rn(b[i], gram.inv(col, i)), l1),
                        __fmul_rn(p.L2, xi));
          d = cd_clamp(diff, -xi);
          const float xn = __fadd_rn(xi, d);
          x[i] = xn;
          part = __fadd_rn(part, __fdiv_rn(fabsf(__fsub_rn(xn, xi)),
                                           __fadd_rn(xn, 1e-15f)));
        }
        const float delta = __shfl_sync(kFull, d, owner);
        // the lane's coordinates kBatch at a time, their Gram entries
        // loaded together before any is used, so that their trips to L2
        // overlap
        for (int t0 = lane; t0 < k; t0 += 32 * kBatch) {
          float av[kBatch];
#pragma unroll
          for (int u = 0; u < kBatch; ++u) {
            const int t = t0 + 32 * u;
            av[u] = t < k ? gram.entry(col, i, t) : 0.f;
          }
#pragma unroll
          for (int u = 0; u < kBatch; ++u) {
            const int t = t0 + 32 * u;
            if (t < k) b[t] = __fsub_rn(b[t], __fmul_rn(av[u], delta));
          }
        }
      }
      float tol = part;
#pragma unroll
      for (int off = 16; off >= 1; off >>= 1) {
        tol = __fadd_rn(tol, __shfl_xor_sync(kFull, tol, off));
      }
      if (!(__fdiv_rn(tol, p.k_div) > kCdTol) || sweep >= p.max_sweeps ||
          !((float)sweep < p.cap)) {
        if (COUNT && lane == 0) {
          // a column's solve outlasts its two atomics by far
          atomicAdd(p.counts, (unsigned long long)sweep);
          atomicAdd(p.counts + 1, 1ull);
        }
        break;
      }
    }
    for (int t = lane; t < k; t += 32) p.X[row + t] = x[t];
  }
}

// ------------------------------------------- B1's staged kernel in quads

// B1's ring: slots of kp floats, 4 intervals of 4 steps (3 where 4 do not
// fit), and its shared memory in floats beside them: x and x_start (C k
// each), the sweep-term sums (C rows of 33), two intervals' deltas (8 C)
__host__ __device__ inline size_t quad_floats(int k, int C, int depth) {
  return (size_t)depth * round4(k) + 2 * round4(C * k) + round4(33 * C) +
         round4(8 * C);
}

__host__ __device__ inline int quad_depth(int k, int C) {
  return quad_floats(k, C, 16) * 4 <= kSmemMax ? 16 : 12;
}

// whether the quad kernel's ring of at least 12 rows fits beside x; where
// it does not, B1 runs staged_kernel on the Gram's rows
__host__ __device__ inline bool quad_fits(int k, int C) {
  return quad_floats(k, C, 12) * 4 <= kSmemMax;
}

// B1 (one Gram for every column) on the staged kernel's ring, with thread
// (l, c) holding coordinates 4 l + e + 4 P v (e = 0..3) of column c: the
// owner of steps 4 q .. 4 q + 3 is one thread, which takes the four
// steps by itself (each delta downdating its later coordinates at once),
// so the block meets once every four steps; each thread then downdates
// its coordinates by the four deltas, reading the staged row 16 bytes at
// a time. The sweep terms are summed at the sweep's end by the threads
// of the lane order (thread l < 32 the steps l, l + 32, ...), so the bits
// are `staged_kernel`'s and `wide_kernel`'s. V: quads a thread, P:
// threads a column (32 or 64).
template <int V, int P, bool COUNT>
__global__ void __launch_bounds__(kMaxThreads)
quad_kernel(const Args p, const SharedGram gram) {
  extern __shared__ __align__(16) float smem[];
  const int C = p.warps;
  const int k = p.k;
  const int kp = gram.kp;
  const int D = p.depth;
  const int nt = C * P;
  const int tid = threadIdx.x;
  const int c = tid % C;
  const int tl = tid / C;
  const long long col = (long long)blockIdx.x * C + c;
  float* ring = smem;
  float* xs = ring + (size_t)D * kp + (size_t)c * k;     // x of column c
  float* x0s = xs + round4(C * k);                       // its x_start
  float* ps = ring + (size_t)D * kp + 2 * round4(C * k);  // C rows of 33
  float* dl = ps + round4(33 * C);                       // [2][4][C]

  const bool in = col < p.n;
  const bool active = in && (p.mask == nullptr || p.mask[col] != 0);
  const size_t row = (size_t)(in ? col : 0) * k;
  for (int t = tl; t < k; t += P) {
    if (active) {
      xs[t] = p.X0[row + t];
    } else if (in) {
      p.X[row + t] = p.X0[row + t];
    }
  }
  bool live = active;
  if (!__syncthreads_or(live)) return;
  float b[V][4];
#pragma unroll
  for (int v = 0; v < V; ++v) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int t = 4 * tl + e + 4 * P * v;
      b[v][e] = active && t < k ? p.B[row + t] : 0.f;
    }
  }

  // the ring: the slab of block step s in slot s mod D, issued once the
  // slab of step s - D is no longer read
  long long s_next = 0;
  int slot_next = 0;
  int step_next = 0;
  for (; s_next < D; ++s_next) {
    gram.stage(ring + (size_t)slot_next * kp, step_next, tid, nt);
    copy_commit();
    slot_next = slot_next + 1 == D ? 0 : slot_next + 1;
    step_next = step_next + 1 == k ? 0 : step_next + 1;
  }
  copy_wait<0>();
  __syncthreads();

  const int windows = (k + 4 * P - 1) / (4 * P);
  // the owner's next quad: its 1/diag (raw) and L1, a window ahead
  float dnext[4], l1next[4];
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const int t = 4 * tl + e;
    dnext[e] = 0.f;
    l1next[e] = p.L1;
    if (live && t < k) {
      dnext[e] = gram.diag(t);
      if (p.l1 != nullptr) l1next[e] = __ldg(p.l1 + row + t);
    }
  }
  long long g0 = 0;      // the block's first step of the interval
  int slot0 = 0;         // its slot
  int lp = 0;            // steps of the previous interval
  int buf = 0;           // its deltas in dl[buf ^ 1], this one's in dl[buf]
  for (int sweep = 1;; ++sweep) {
    for (int u = 0; u < windows; ++u) {
      // window u: intervals q = 0 .. P - 1 of steps 4 P u + 4 q + j;
      // thread l owns interval l, its quad to + e
      const int to = 4 * tl + 4 * P * u;
      float bo[4], inv_o[4], l1_o[4], x_o[4], l2x_o[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        bo[e] = 0.f;     // b[u][e], downdated beside it
#pragma unroll
        for (int v = 0; v < V; ++v) {
          if (v == u) bo[e] = b[v][e];
        }
        inv_o[e] = __frcp_rn(dnext[e]);
        l1_o[e] = l1next[e];
        const bool own = live && to + e < k;
        x_o[e] = own ? xs[to + e] : 0.f;
        if (own) x0s[to + e] = x_o[e];
        l2x_o[e] = __fmul_rn(p.L2, x_o[e]);
      }
      const int tn = u + 1 < windows ? to + 4 * P : 4 * tl;
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        if (live && tn + e < k) {
          dnext[e] = gram.diag(tn + e);
          if (p.l1 != nullptr) l1next[e] = __ldg(p.l1 + row + tn + e);
        }
      }
      const int steps = k - 4 * P * u < 4 * P ? k - 4 * P * u : 4 * P;
      for (int r = 0; r < steps; r += 4) {
        const int lc = steps - r < 4 ? steps - r : 4;
        const int rest = steps - r - lc;
        const int ln = rest > 0 ? (rest < 4 ? rest : 4)
                                : (u + 1 < windows && k - 4 * P * (u + 1) < 4
                                       ? k - 4 * P * (u + 1) : 4);
        for (; s_next < g0 - lp + D; ++s_next) {
          gram.stage(ring + (size_t)slot_next * kp, step_next, tid, nt);
          copy_commit();
          slot_next = slot_next + 1 == D ? 0 : slot_next + 1;
          step_next = step_next + 1 == k ? 0 : step_next + 1;
        }
        const float* dprev = dl + (buf ^ 1) * 4 * C;
        float* dcur = dl + buf * 4 * C;
        const int slotp = slot0 - lp < 0 ? slot0 - lp + D : slot0 - lp;
        if (live && to < kp) {
          // the quad first, by the previous interval's deltas
          for (int j = 0; j < lp; ++j) {
            const int sj = slotp + j < D ? slotp + j : slotp + j - D;
            const float4 a = *reinterpret_cast<const float4*>(
                ring + (size_t)sj * kp + to);
            const float d = dprev[j * C + c];
            bo[0] = __fsub_rn(bo[0], __fmul_rn(a.x, d));
            bo[1] = __fsub_rn(bo[1], __fmul_rn(a.y, d));
            bo[2] = __fsub_rn(bo[2], __fmul_rn(a.z, d));
            bo[3] = __fsub_rn(bo[3], __fmul_rn(a.w, d));
          }
        }
        if (live && tl == (r >> 2)) {
          // this thread's four steps
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            if (j < lc) {
              const float diff = __fadd_rn(
                  __fsub_rn(__fmul_rn(bo[j], inv_o[j]), l1_o[j]), l2x_o[j]);
              const float dn = cd_clamp(diff, -x_o[j]);
              dcur[j * C + c] = dn;
              xs[to + j] = __fadd_rn(x_o[j], dn);
              const int sj = slot0 + j < D ? slot0 + j : slot0 + j - D;
              const float4 a = *reinterpret_cast<const float4*>(
                  ring + (size_t)sj * kp + to);
              const float av[4] = {a.x, a.y, a.z, a.w};
#pragma unroll
              for (int m = j + 1; m < 4; ++m) {
                bo[m] = __fsub_rn(bo[m], __fmul_rn(av[m], dn));
              }
            }
          }
        }
        if (live) {
          for (int j = 0; j < lp; ++j) {
            const int sj = slotp + j < D ? slotp + j : slotp + j - D;
            const float* sl = ring + (size_t)sj * kp;
            const float d = dprev[j * C + c];
#pragma unroll
            for (int v = 0; v < V; ++v) {
              const int t = 4 * tl + 4 * P * v;
              if (t < kp) {
                const float4 a = *reinterpret_cast<const float4*>(sl + t);
                b[v][0] = __fsub_rn(b[v][0], __fmul_rn(a.x, d));
                b[v][1] = __fsub_rn(b[v][1], __fmul_rn(a.y, d));
                b[v][2] = __fsub_rn(b[v][2], __fmul_rn(a.z, d));
                b[v][3] = __fsub_rn(b[v][3], __fmul_rn(a.w, d));
              }
            }
          }
        }
        const long long pend = s_next - (g0 + lc + ln);
        copy_wait_upto(pend > 6 ? 6 : (int)pend);
        __syncthreads();
        g0 += lc;
        slot0 = slot0 + lc < D ? slot0 + lc : slot0 + lc - D;
        lp = lc;
        buf ^= 1;
      }
    }
    sweep_end<COUNT>(p, live, xs, x0s, ps, c, tl, sweep);
    if (!__syncthreads_or(live)) break;
  }
  copy_wait<0>();
  if (active) {
    for (int t = tl; t < k; t += P) p.X[row + t] = xs[t];
  }
  if constexpr (COUNT) count_block(p, ps, tid, C, active);
}

template <int V, int P, bool COUNT>
cudaError_t launch_quad_v(const Args& p, const SharedGram& gram, int blocks,
                          size_t smem, cudaStream_t s) {
  auto kernel = quad_kernel<V, P, COUNT>;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
  }
  kernel<<<blocks, p.warps * P, smem, s>>>(p, gram);
  return cudaGetLastError();
}

// B1's staged route where its ring fits (P = 32 or 64): the quad kernel on
// its own ring (p.depth set here); the caller has checked C, P, k, the
// scratch and the blocks
template <bool COUNT>
cudaError_t launch_quad(Args p, const SharedGram& gram, int blocks,
                               cudaStream_t s) {
  p.depth = quad_depth(p.k, p.warps);
  const size_t smem = 4 * quad_floats(p.k, p.warps, p.depth);
  if (smem > kSmemMax) return cudaErrorInvalidValue;
  const int v = (p.k + 4 * p.lanes - 1) / (4 * p.lanes);
  if (p.lanes == 64) {   // k > 2048: v > 8
    if (v <= 10) return launch_quad_v<10, 64, COUNT>(p, gram, blocks, smem, s);
    if (v <= 12) return launch_quad_v<12, 64, COUNT>(p, gram, blocks, smem, s);
    return launch_quad_v<16, 64, COUNT>(p, gram, blocks, smem, s);
  }
  if (v <= 5) return launch_quad_v<5, 32, COUNT>(p, gram, blocks, smem, s);
  if (v <= 6) return launch_quad_v<6, 32, COUNT>(p, gram, blocks, smem, s);
  if (v <= 8) return launch_quad_v<8, 32, COUNT>(p, gram, blocks, smem, s);
  if (v <= 10) return launch_quad_v<10, 32, COUNT>(p, gram, blocks, smem, s);
  if (v <= 12) return launch_quad_v<12, 32, COUNT>(p, gram, blocks, smem, s);
  return launch_quad_v<16, 32, COUNT>(p, gram, blocks, smem, s);
}

// ---------------------------------------------------------------- launch

template <int U, int P, bool COUNT, class GRAM>
cudaError_t launch_staged_u(const Args& p, const GRAM& gram, int blocks,
                            size_t smem, cudaStream_t s) {
  auto kernel = staged_kernel<U, P, COUNT, GRAM>;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
  }
  kernel<<<blocks, p.warps * P, smem, s>>>(p, gram);
  return cudaGetLastError();
}

// the staged kernel at P threads a column: U the instantiated size at or
// above ceil(k / P) (past P = 32, where the plan takes the fewest threads
// that fit, ceil(k / P) > 32; B1 runs it from k = 2049 only)
template <int P, bool COUNT, class GRAM>
cudaError_t launch_staged_p(const Args& p, const GRAM& gram, int blocks,
                            size_t smem, cudaStream_t s) {
  const int u = (p.k + P - 1) / P;
  if constexpr (P == 32 && std::is_same_v<GRAM, SharedGram>) {
    return cudaErrorInvalidValue;   // B1 takes the quad kernel there
  } else {
    const int b = blocks;
    if constexpr (P == 32) {
      if (u <= 20) return launch_staged_u<20, P, COUNT>(p, gram, b, smem, s);
      if (u <= 24) return launch_staged_u<24, P, COUNT>(p, gram, b, smem, s);
      if (u <= 32) return launch_staged_u<32, P, COUNT>(p, gram, b, smem, s);
    }
    if (u <= 40) return launch_staged_u<40, P, COUNT>(p, gram, b, smem, s);
    if (u <= 48) return launch_staged_u<48, P, COUNT>(p, gram, b, smem, s);
    return launch_staged_u<64, P, COUNT>(p, gram, b, smem, s);
  }
}

// the launch of a plan: with a depth, a staged kernel (C = p.warps columns
// a block of P = p.lanes threads each, `blocks` = ceil(n / C); B1 the
// quad kernel where its ring fits); else wide_kernel, `blocks` blocks of
// `warps` columns (a warp each), with scratch null each block holding
// warps * 2 k floats of dynamic shared memory. COUNT: the kernels that add
// to p.counts, instantiations of their own (`launch`)
template <bool COUNT, class GRAM>
cudaError_t launch_route(Args p, const GRAM& gram, int blocks,
                         cudaStream_t s) {
  if (p.n <= 0) return cudaSuccess;
  if (p.k <= 0 || p.warps < 1 || p.warps > kMaxWarps || blocks < 1) {
    return cudaErrorInvalidValue;
  }
  if (p.depth > 0) {
    const int C = p.warps;
    const int P = p.lanes;
    if ((C != 1 && C != 2 && C != 4 && C != 8) ||
        (P != 32 && P != 64 && P != 128 && P != 256) || C * P > kMaxThreads ||
        (p.k + P - 1) / P > kMaxU || p.depth < 3 || p.depth > kMaxDepth ||
        p.scratch != nullptr || (long long)blocks * C < p.n) {
      return cudaErrorInvalidValue;
    }
    if constexpr (std::is_same_v<GRAM, SharedGram>) {
      if (P <= 64 && quad_fits(p.k, C)) {
        return launch_quad<COUNT>(p, gram, blocks, s);
      }
    }
    const size_t smem = 4 * staged_floats(p.k, C, p.depth, gram.slab(C),
                                          GRAM::kRowStarts);
    if (smem > kSmemMax) return cudaErrorInvalidValue;
    switch (P) {
      case 32: return launch_staged_p<32, COUNT>(p, gram, blocks, smem, s);
      case 64: return launch_staged_p<64, COUNT>(p, gram, blocks, smem, s);
      case 128:
        return launch_staged_p<128, COUNT>(p, gram, blocks, smem, s);
      default:
        return launch_staged_p<256, COUNT>(p, gram, blocks, smem, s);
    }
  }
  const size_t smem =
      p.scratch != nullptr ? 0 : (size_t)p.warps * 2 * p.k * sizeof(float);
  if (smem > kSmemMax) return cudaErrorInvalidValue;
  auto kernel = wide_kernel<GRAM, COUNT>;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
  }
  kernel<<<blocks, p.warps * 32, smem, s>>>(p, gram);
  return cudaGetLastError();
}

// a plan's launch: with a counter the counting kernels, else the kernels
// with no counting code at all
template <class GRAM>
cudaError_t launch(Args p, const GRAM& gram, int blocks, cudaStream_t s) {
  return p.counts != nullptr ? launch_route<true>(p, gram, blocks, s)
                             : launch_route<false>(p, gram, blocks, s);
}

}  // namespace nnls_wide

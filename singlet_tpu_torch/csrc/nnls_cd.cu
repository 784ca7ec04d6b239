// Batched warm-started coordinate-descent NNLS against one shared Gram
// matrix: kernel B1 of the port, for sm_90a.
//
// Replaces singlet_tpu/ops/pallas_nnls.py `nnls_batch_pallas` (kernel body
// `_nnls_kernel`). It computes, for every column c of B (n, k), what the
// plain version `singlet_tpu_torch.ops.nnls.nnls_batch` computes with a 2-D
// Gram and a scalar or per-coordinate (n, k) L1:
//
//   repeat sweeps:  for i in 0..k-1:
//     diff  = b_i * inv_diag_i - L1[c, i] + L2 * x_i
//     delta = max(diff, -x_i)    (clamp at zero; a NaN kept, `cd_clamp`)
//     x_i  += delta;  b -= a[:, i] * delta    (incremental residual downdate)
//   tol = sum_i |x_i - x_prev_i| / (x_i + 1e-15)
//   stop when tol / k_div <= 1e-8, or sweep >= max_sweeps, or sweep >= cap
//
// b starts at the RAW right-hand side (not B - a X0) and x at X0: with the
// caller's column rescale that is the reference's damped update. Columns
// whose mask byte is 0 return X0 bit for bit.
//
// What bounds B1. Each sweep is a chain of k dependent steps (the owner's
// b downdate, diff and clamp, the broadcast of delta: about 60 cycles on
// an H100), with a data-dependent exit per column; B, X0 and X cross
// device memory once each, so bytes do not bound it. At the card's column
// counts the chains of many columns overlap, and what bounds it is the
// issue of each step's instructions and its shared-memory loads of the
// Gram's column i. The parent gave each column a warp: every lane repeated
// the step's scalar chain and loaded ceil(k / 32) entries, of which the
// slots past k (14 of 64 at k = 50) did nothing; about 45 warp
// instructions per column and step.
//
// The design: G lanes per column (G = 2, 4, 8, 16 or 32, `b1_plan` in
// ops/nnls_cuda.py picks it from n and k), so a warp sweeps 32 / G columns
// at once, each group of G lanes its own column. Lane p of a group keeps
// coordinates p, p + G, p + 2G, ... (NPL = ceil(k / G) of them, a template
// parameter) of x and of the residual b in registers, and reads their
// 1/diag and L1 from shared memory once a slot (the sweep's tolerance
// terms wait there too): so a block of 8 warps takes at most 128
// registers a thread up to NPL = 13, and two blocks fit an SM. At
// step i the owner, lane i mod G, computes diff and delta and broadcasts
// delta to its group (__shfl_sync of width G); every lane then downdates
// its own coordinates from column i of the Gram. The scalar chain is paid
// once per 32 / G columns and the loads once per warp. The Gram is staged
// once per block into shared memory, transposed (row i holds column i, and
// row k column 0 again, for the step after the last), with lane p's NPL
// entries of a row contiguous at p * pitch: the step's loads are immediate
// offsets from one address, and the groups of a warp read the same
// addresses (a broadcast). Where it fits (NPL >= 4) the pitch is 4 mod 8
// floats and the lane reads its run with 16-byte loads, the 8 lanes of a
// quarter-warp on distinct banks (NPL up to 16: G = 4 at k = 50, 8 at
// k = 100); else it is odd and the loads are scalar, a group's lanes on
// distinct banks (NPL up to 8). A step applies the previous step's delta
// with that step's entries, first to the owner's slot, whose b its diff
// reads, and to the other slots once its own delta is on its way (each b
// still takes the deltas in step order), then loads the entries of step
// i + 1 into the buffer it just read: two steps before they are used,
// with no copy (two buffers alternate) and no wrap. The sweep is one loop
// body of two steps per slot, so the code stays small. Warps are
// persistent: the grid holds what fits on the card at once (two blocks an
// SM up to NPL = 13) and each warp takes column sets in turn, so the Gram
// is staged once per block. Per
// warp and step: 2 NPL downdate instructions, ceil(NPL / 4) or NPL loads,
// about 10 more, and one shuffle, for 32 / G columns; 1/diag is formed
// here (__frcp_rn, correctly rounded as the plain version's division).
//
// A warp's groups step in lockstep: a column that has stopped keeps its x
// and idles (its b runs on unread) until every column of its warp has
// stopped; a column that stops early costs sweeps the parent's per-column
// warp did not pay.
//
// The parent's bits. Each step rounds as the plain version does (the _rn
// intrinsics: nvcc contracts nothing into FMAs), so x and b depend only on
// the sweep count, which depends on the order the sweep tolerance is
// summed in. That order stays the parent's: lane l of the parent summed
// the terms of coordinates i = l (mod 32) in step order, then the lanes'
// sums by the xor butterfly 16, 8, 4, 2, 1. Lane p of a group holds
// exactly the parent's lanes l = p, p + G, ... (register j of lane p is
// parent lane p + G (j mod 32 / G)), so it forms their partials in the
// same order; the butterfly's offsets >= G become adds between its own
// partials and the offsets < G shuffles of width G. Each level adds the
// same two values as the parent's (addition commutes): the outputs equal
// the parent's bit for bit. Build WITHOUT --use_fast_math: the clamp term
// x_i / 1e-15 and the tol / k <= 1e-8 exit need IEEE division and
// denormals kept.
//
// Ranks above 224. The staged Gram takes (k + 1) G pitch 4 bytes of
// shared memory, at most 201,600 for k <= 224 (of the 232,448 a block may
// use), and the terms, L1 and 1/diag 17 NPL 128 more. For 224 < k <= 512 the kernel reads the transposed Gram from
// device memory through L1 instead (made by the caller, its rows padded
// with zeros to 32 NPL floats, row k a copy of row 0), with G = 32 and NPL
// = 8, 10, 12, 14 or 16: one launch for every k <= 512, the same
// arithmetic.
//
// Ranks above 512: nnls_wide.cu (`nnls_wide_b1`), whose note is in
// nnls_wide.cuh; this source takes `cd_clamp` from there.
//
// The counters. Given a (sweeps, columns) pair in device memory (the
// wrapper passes one while the port's tracing is on, else null), each
// column whose mask lets it move adds the sweeps it ran before it stopped,
// and 1: a lane per column keeps them over its warp's column sets, and at
// the end each warp adds its sums with one atomicAdd each (`count_cd`,
// nnls_wide.cuh). That takes registers, which the kernels at NPL = 11 to
// 13 do not have to spare, so the counting kernel is an instantiation of
// its own (COUNT), launched only with a counter: null, the launch runs
// the kernel as it was.

#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "nnls_wide.cuh"

namespace {

constexpr int kWarps = 8;             // warps a block
constexpr int kThreads = kWarps * 32;
constexpr float kCdTol = 1e-8f;       // CD_TOL of ops/nnls.py
constexpr unsigned kFull = 0xffffffffu;
constexpr int kMaxKShared = 224;
constexpr int kMaxK = 512;
constexpr int kMaxNplStaged = 8;     // coordinates a lane at an odd pitch
constexpr size_t kSmemMax = 232448;   // a Hopper block's shared memory

// f(integral_constant<int, I>) for I in [B, E): loop indices that
// `if constexpr` and register arrays can take
template <int B, int E, class F>
__device__ __forceinline__ void static_for(F&& f) {
  if constexpr (B < E) {
    f(std::integral_constant<int, B>{});
    static_for<B + 1, E>(f);
  }
}

struct Args {
  const float* a;        // (k, k)
  const float* aT;       // device-memory route: (k, 32 NPL), else null
  const float* l1;       // (n, k) per-coordinate L1, or null for L1
  const float* B;        // (n, k)
  const float* X0;       // (n, k)
  const uint8_t* mask;   // (n,) or null
  float* X;              // (n, k)
  unsigned long long* counts;   // (sweeps, columns) to add to, or null
  int n, k, g, max_sweeps;
  int pitch;             // floats of a lane's run of a staged row
  int sets;              // column sets of 32 / g columns
  float L1, L2, k_div, cap;
};

// a staged row's pitch for lane runs of npl floats: npl rounded up to odd,
// so that the lanes of a group read distinct banks
__host__ __device__ constexpr int lane_pitch(int npl) { return npl | 1; }

// shared memory of the warps' sweep terms and L1, and of 1/diag
// (ops/nnls_cuda.py adds the same)
__host__ __device__ constexpr size_t term_bytes(int npl) {
  return (size_t)(2 * kWarps + 1) * npl * 32 * sizeof(float);
}

// the pitch of 16-byte lane runs: npl rounded up to 4, then to 4 mod 8
// floats, so that the 8 lanes of a quarter-warp read distinct banks
__host__ __device__ constexpr int vec_pitch(int npl) {
  return ((npl + 3) / 4 % 2 == 1) ? (npl + 3) / 4 * 4 : (npl + 3) / 4 * 4 + 4;
}

// The sweep tolerance of one column in the parent's order, from the terms
// of this lane's coordinates (term j: coordinate j G + p, zero past k): R
// = 32 / G partials, partial r the parent lane p + G r's, summed in step
// order; then the parent's butterfly, its offsets >= G inside the lane and
// the offsets < G across the group.
template <int R, int NPL>
__device__ __forceinline__ float tol_reduce(const float* term) {
  constexpr int G = 32 / R;
  float part[R];
#pragma unroll
  for (int r = 0; r < R; ++r) part[r] = 0.f;
  static_for<0, NPL>([&](auto jc) {
    constexpr int j = decltype(jc)::value;
    part[j % R] = __fadd_rn(part[j % R], term[32 * j]);
  });
  // levels m = R / 2, R / 4, ..., 1 (the parent's offsets 16 .. G)
  static_for<0, 5>([&](auto lc) {
    constexpr int m = (R / 2) >> decltype(lc)::value;
    if constexpr (m >= 1) {
      static_for<0, m>([&](auto rc) {
        constexpr int r = decltype(rc)::value;
        part[r] = __fadd_rn(part[r], part[r + m]);
      });
    }
  });
  float v = part[0];
#pragma unroll
  for (int off = G / 2; off >= 1; off /= 2) {
    v = __fadd_rn(v, __shfl_xor_sync(kFull, v, off, G));
  }
  return v;
}

// term: this lane's terms in shared memory, term j at term[32 j]
template <int NPL>
__device__ __forceinline__ float column_tol(const float* term, int g) {
  switch (g) {
    case 2: return tol_reduce<16, NPL>(term);
    case 4: return tol_reduce<8, NPL>(term);
    case 8: return tol_reduce<4, NPL>(term);
    case 16: return tol_reduce<2, NPL>(term);
    default: return tol_reduce<1, NPL>(term);
  }
}

// NPL: coordinates a lane (k <= G NPL). ROUTE: kStaged, the Gram staged in
// shared memory with lane runs at an odd pitch (scalar loads); kStagedVec,
// the same at a pitch of 4 mod 8 floats (16-byte loads, no bank conflict
// in a quarter-warp); kDevice: the transposed Gram from
// device memory (aT, rows of 32 NPL floats, lane p's coordinates at
// t 32 + p), else staged in shared memory (rows of G pitch floats, lane
// p's at p pitch + t).
enum Route : int { kStaged = 0, kStagedVec = 1, kDevice = 2 };

// blocks an SM should hold: two (16 warps, at most 128 registers a thread,
// to hide the step's latency) where a lane's arrays fit in them
__host__ __device__ constexpr int min_blocks(int npl, int route) {
  return route != kDevice && npl <= 13 ? 2 : 1;
}

template <int NPL, int ROUTE, bool COUNT>
__global__ void __launch_bounds__(kThreads, min_blocks(NPL, ROUTE))
nnls_cd_kernel(const Args p) {
  constexpr bool kGlobal = ROUTE == kDevice;
  extern __shared__ __align__(16) float sT[];
  const int k = p.k;
  const int G = p.g;
  const int pitch = p.pitch;
  const int row = kGlobal ? 32 * NPL : G * pitch;   // floats a Gram row
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int pl = lane & (G - 1);   // the column's lane
  const int grp = lane / G;        // the warp's column

  if constexpr (!kGlobal) {
    // row i of the staged Gram holds column i of a, and row k column 0
    // again (the step after the last); a's row c is read whole (coalesced)
    // and scattered to its coordinate's place, coordinates past k (to G
    // NPL) are zero
    // (unrolled, so that a warp's loads of several rows are in flight at
    // once: the grid's blocks all stage the same Gram, and a small call's
    // time is mostly this and the launch)
#pragma unroll 4
    for (int c = warp; c < G * NPL; c += kWarps) {
      float* dst = sT + (c % G) * pitch + c / G;
      const float* src = p.a + (size_t)min(c, k - 1) * k;
      for (int i = lane; i <= k; i += 32) {
        const float v = __ldg(src + (i < k ? i : 0));
        dst[(size_t)i * row] = c < k ? v : 0.f;
      }
    }
  }
  // the shared memory after the staged rows: the warps' sweep terms, their
  // columns' L1 and 1/diag of every coordinate (zero past k); a lane reads
  // its L1 and 1/diag once a slot, so they take no registers
  float* sterm = sT + (kGlobal ? 0 : (size_t)(k + 1) * row);
  float* l1w = sterm + (size_t)kWarps * NPL * 32 + (size_t)warp * NPL * 32 +
               lane;
  float* sinv = sterm + (size_t)2 * kWarps * NPL * 32;
  for (int c = threadIdx.x; c < G * NPL; c += kThreads) {
    sinv[c] = c < k ? __frcp_rn(__ldg(p.a + (size_t)c * k + c)) : 0.f;
  }
  __syncthreads();
  // this lane's entries of Gram row i are at arow + i row + t (shared) or
  // + t 32 (device memory)
  const float* arow = kGlobal ? p.aT + lane : sT + pl * pitch;

  auto fetch = [&](int i, float (&av)[NPL]) {
    if constexpr (ROUTE == kStagedVec) {
      const float4* src =
          reinterpret_cast<const float4*>(arow + (size_t)i * row);
#pragma unroll
      for (int u = 0; u < (NPL + 3) / 4; ++u) {
        const float4 v = src[u];
        av[4 * u] = v.x;
        if (4 * u + 1 < NPL) av[4 * u + 1] = v.y;
        if (4 * u + 2 < NPL) av[4 * u + 2] = v.z;
        if (4 * u + 3 < NPL) av[4 * u + 3] = v.w;
      }
    } else {
#pragma unroll
      for (int t = 0; t < NPL; ++t) {
        av[t] = kGlobal ? __ldg(arow + (size_t)i * row + t * 32)
                        : arow[(size_t)i * row + t];
      }
    }
  };

  const int per_warp = 32 / G;
  const int total_warps = gridDim.x * kWarps;
  // the sweeps and columns of this lane's columns (group lane 0 of each)
  unsigned cd_sweeps = 0, cd_cols = 0;
  for (int set = blockIdx.x * kWarps + warp; set < p.sets;
       set += total_warps) {
    const int col = set * per_warp + grp;
    const bool valid = col < p.n;
    bool active = valid && (p.mask == nullptr || p.mask[col] != 0);
    const bool counted = COUNT && active && pl == 0;
    int ran = 0;   // sweeps the column ran (COUNT)
    float b[NPL], x[NPL];
#pragma unroll
    for (int t = 0; t < NPL; ++t) {
      const int c = t * G + pl;
      const bool own = valid && c < k;
      const size_t e = (size_t)col * k + c;
      b[t] = own ? p.B[e] : 0.f;
      x[t] = own ? p.X0[e] : 0.f;
      l1w[32 * t] = p.l1 == nullptr ? p.L1 : own ? p.l1[e] : 0.f;
    }

    if (__any_sync(kFull, active)) {
      // one step of owner slot q at group lane o. The downdate by the
      // previous step's delta d_prev, with that step's Gram entries in av,
      // goes first to slot q, whose b the owner's diff reads, and to the
      // other slots once this step's delta is on its way: each b still
      // takes the deltas in step order, and the chain from one delta to
      // the next holds only the owner's slot. av then takes the entries of
      // step i + 1 (row k: step 0 of the next sweep), two steps before
      // they are used (loads one step ahead were sunk onto the chain).
      float d_prev = 0.f;
      auto step = [&](auto qc, int o, float inv_q, float l1_q,
                      float (&av)[NPL]) {
        constexpr int q = decltype(qc)::value;
        b[q] = __fsub_rn(b[q], __fmul_rn(av[q], d_prev));
        const float x_i = x[q];
        const float diff = __fadd_rn(
            __fsub_rn(__fmul_rn(b[q], inv_q), l1_q), __fmul_rn(p.L2, x_i));
        const float delta = __shfl_sync(kFull, cd_clamp(diff, -x_i), o, G);
        if (pl == o && active) x[q] = __fadd_rn(x_i, delta);
#pragma unroll
        for (int t = 0; t < NPL; ++t) {
          if (t != q) b[t] = __fsub_rn(b[t], __fmul_rn(av[t], d_prev));
        }
        d_prev = delta;
        fetch(q * G + o + 1, av);
      };

      // step i reads a1 if i is even, a0 if odd (G is even, so every slot
      // starts at an even step); before step 0 they hold the entries of
      // "step -1" (zeros, with d_prev 0) and of step 0
      float a0[NPL], a1[NPL];
#pragma unroll
      for (int t = 0; t < NPL; ++t) a1[t] = 0.f;
      fetch(0, a0);
      for (int sweep = 1;; ++sweep) {
        // the sweep's terms wait in shared memory, not in registers
        float* term = sterm + (size_t)warp * NPL * 32 + lane;
        static_for<0, NPL>([&](auto qc) {
          constexpr int q = decltype(qc)::value;
          const float x_start = x[q];
          const float inv_q = sinv[q * G + pl];   // 1/diag of coordinate q
          const float l1_q = l1w[32 * q];          // and its L1
          // G steps (the last slot k - q G, maybe odd), two an iteration,
          // in one loop body: the sweep's code stays small
          const int steps = min(G, k - q * G);
#pragma unroll 1
          for (int o = 0; o + 1 < steps; o += 2) {
            step(qc, o, inv_q, l1_q, a1);
            step(qc, o + 1, inv_q, l1_q, a0);
          }
          if constexpr (q + 2 >= NPL) {
            // the last slot with steps (past k: none, where the device-
            // memory route rounds NPL up to even) may have an odd count
            if (steps > 0 && (steps & 1)) {
              step(qc, steps - 1, inv_q, l1_q, a1);
            }
          }
          term[32 * q] = q * G + pl < k
                             ? __fdiv_rn(fabsf(__fsub_rn(x[q], x_start)),
                                         __fadd_rn(x[q], 1e-15f))
                             : 0.f;
        });
        if (k & 1) {
          // an odd sweep ended reading a1: the next one starts there too
#pragma unroll
          for (int t = 0; t < NPL; ++t) {
            const float s = a0[t];
            a0[t] = a1[t];
            a1[t] = s;
          }
        }
        const float tol = column_tol<NPL>(term, G);
        if (COUNT && active) ran = sweep;
        if (!(__fdiv_rn(tol, p.k_div) > kCdTol) || sweep >= p.max_sweeps ||
            !((float)sweep < p.cap)) {
          active = false;
        }
        if (!__any_sync(kFull, active)) break;
      }
    }
    if constexpr (COUNT) {
      if (counted) {
        cd_sweeps += ran;
        cd_cols += 1;
      }
    }

    if (valid) {
#pragma unroll
      for (int t = 0; t < NPL; ++t) {
        const int c = t * G + pl;
        if (c < k) p.X[(size_t)col * k + c] = x[t];
      }
    }
  }
  if constexpr (COUNT) count_cd(p.counts, cd_sweeps, cd_cols);
}

template <int NPL, int ROUTE, bool COUNT>
cudaError_t launch(Args p, cudaStream_t stream) {
  constexpr bool kGlobal = ROUTE == kDevice;
  auto kernel = nnls_cd_kernel<NPL, ROUTE, COUNT>;
  const size_t smem =
      (kGlobal ? 0 : (size_t)(p.k + 1) * p.g * p.pitch * sizeof(float)) +
      term_bytes(NPL);
  if (smem > kSmemMax) return cudaErrorInvalidValue;
  // per instantiation: the card's multiprocessors (on first launch), and
  // the blocks one holds at the last call's shared memory
  static int sms = 0;
  static size_t last_smem = ~(size_t)0;
  static int per_sm = 1;
  if (sms == 0) {
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)kSmemMax);
    if (err != cudaSuccess) return err;
    int dev = 0;
    err = cudaGetDevice(&dev);
    if (err != cudaSuccess) return err;
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return err;
  }
  if (smem != last_smem) {
    int fit = 0;
    const cudaError_t err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &fit, kernel, kThreads, smem);
    if (err != cudaSuccess) return err;
    per_sm = fit > 0 ? fit : 1;
    last_smem = smem;
  }
  const int needed = (p.sets + kWarps - 1) / kWarps;
  const int blocks = needed < per_sm * sms ? needed : per_sm * sms;
  kernel<<<blocks, kThreads, smem, stream>>>(p);
  return cudaGetLastError();
}

// the (NPL, route) instantiated: kStaged NPL <= 8, kStagedVec 4..16,
// kDevice even NPL from 8
template <int ROUTE>
constexpr bool instantiated(int npl) {
  return ROUTE == kStaged ? npl <= kMaxNplStaged
         : ROUTE == kStagedVec ? npl >= 4
                               : npl >= 8 && npl % 2 == 0;
}

template <int ROUTE, int I = 1>
cudaError_t launch_npl(const Args& p, int npl, cudaStream_t s) {
  if constexpr (I <= 16) {
    if (npl == I) {
      if constexpr (instantiated<ROUTE>(I)) {
        return p.counts != nullptr ? launch<I, ROUTE, true>(p, s)
                                   : launch<I, ROUTE, false>(p, s);
      }
      return cudaErrorNotSupported;
    }
    return launch_npl<ROUTE, I + 1>(p, npl, s);
  }
  return cudaErrorNotSupported;
}

}  // namespace

extern "C" {

// All pointers are device pointers to contiguous float32 (mask: uint8, or
// null for all columns active): a (k, k), B / X0 / X (n, k), l1 (n, k) or
// null for the scalar L1. g: lanes a column (1, 2, 4, 8, 16 or 32, with
// ceil(k / g) <= 16). For k <= 224 the Gram is staged in shared memory and
// aT is not read; for 224 < k <= 512, g = 32 and aT is the transposed Gram
// (aT[i, c] = a[c, i]) with rows of 32 npl floats, npl = ceil(k / 32)
// rounded up to even, zero past k. counts: null, or two uint64 that the
// call adds its columns' sweeps and its columns to. Returns the cudaError_t
// of the launch (0 on success).
int nnls_cd(const float* a, const float* aT, const float* l1, const float* B,
            const float* X0, const uint8_t* mask, float* X, int n, int k,
            int g, float L1, float L2, float k_div, float cap, int max_sweeps,
            unsigned long long* counts, void* stream) {
  if (n <= 0) return cudaSuccess;
  if (k <= 0 || k > kMaxK || g < 2 || g > 32 || (g & (g - 1)) != 0) {
    return cudaErrorInvalidValue;
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  Args p{};
  p.a = a;
  p.aT = aT;
  p.l1 = l1;
  p.B = B;
  p.X0 = X0;
  p.mask = mask;
  p.X = X;
  p.counts = counts;
  p.n = n;
  p.k = k;
  p.g = g;
  p.max_sweeps = max_sweeps;
  p.L1 = L1;
  p.L2 = L2;
  p.k_div = k_div;
  p.cap = cap;
  const int per_warp = 32 / g;
  p.sets = (int)(((long long)n + per_warp - 1) / per_warp);
  int npl = (k + g - 1) / g;
  if (npl > 16) return cudaErrorInvalidValue;
  if (k <= kMaxKShared) {
    // 16-byte loads where the wider pitch fits (ops/nnls_cuda.py
    // `b1_plan` takes the same route)
    if (npl >= 4 && (size_t)(k + 1) * g * vec_pitch(npl) * 4 +
                            term_bytes(npl) <= kSmemMax) {
      p.pitch = vec_pitch(npl);
      return launch_npl<kStagedVec>(p, npl, s);
    }
    if (npl > kMaxNplStaged) return cudaErrorInvalidValue;
    p.pitch = lane_pitch(npl);
    return launch_npl<kStaged>(p, npl, s);
  }
  if (g != 32 || aT == nullptr) return cudaErrorInvalidValue;
  npl += npl & 1;
  p.pitch = 32 * npl;
  return launch_npl<kDevice>(p, npl, s);
}

const char* nnls_cd_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"

"""Time two versions of kernel B2 (``csrc/nnls_cd_batched.cu``) against
each other on one CUDA card, in turns, on the same inputs.

    python3 -m singlet_tpu_torch.ab_nnls_batched OLD.cu NEW.cu
    python3 -m singlet_tpu_torch.ab_nnls_batched --wide [OLD.cu]

``--wide`` times B2's wide-k route (k > 512) instead: the checkout's
staged kernel (``csrc/nnls_wide.cu`` ``nnls_wide_b2_packed`` on the plan
of ``ops/nnls_cuda.py`` ``nnls_wide_plan``) against the warp-a-column
kernel it replaced: up to k = 2048 OLD.cu's
``nnls_cd_batched_packed_wide``, by default ``csrc/nnls_wide_warp.cu``,
that kernel kept as it was compiled, or a source of an earlier commit
(``git show 7249670:singlet_tpu_torch/csrc/nnls_cd_batched.cu`` with that
commit's ``nnls_wide.cuh`` beside it); past k = 2048 the checkout's own
warp-a-column kernel (``nnls_wide.cuh`` ``wide_kernel``, the route there
before the staged kernels took more threads a column, still the route
past their reach), forced through the same entry by its plan. Per (n, k)
in ``WIDE_SHAPES`` the packed entry (past k = 2048 the tile entry too) at
sweep cap 8, in the order old, new, new, old for ``WIDE_ROUNDS`` rounds,
a turn the median of ``WIDE_RUNS`` single calls by CUDA events (one call
where the old route's first call took longer than ``WIDE_SLOW_MS``); the
outputs must be equal bit for bit, and the first 512 columns (64 past k
= 2048) within the B2 gate of the plain version. One JSON line per shape
with every turn's time, the medians, each side's range over its turns,
and the card's name and power limit.

Both sources are compiled with ``_build``'s nvcc flags, started together,
into the git-ignored ``build/``. Per (n, k) in ``SHAPES`` the inputs are
those of a masked half-update (a_full and the packed corrections of 5%
masked rows, and the per-column Grams ``at`` unpacked from them; sweep
cap 32). Two comparisons, each timed per turn as the median of ``RUNS``
calls by CUDA events, in the order old, new, new, old repeated ``ROUNDS``
times:

- ``at``: both sources' tile entry ``nnls_cd_batched`` on ``at``;
- ``packed``: what a masked solve costs, the old way against the new: the
  unpack (``linalg.unpack_sym_from_t``), 1/diag and the old tile entry,
  against the new source's packed entry ``nnls_cd_batched_packed`` on
  ``a_full`` and ``packed_t`` (it forms 1/diag itself).

All outputs must be equal bit for bit. Prints one JSON line per shape with
every turn's time and the card's name and power limit. First, one line
``chain``: the cycles per step (clock64 on one warp) of the CD step's
serial chain alone, the floor of a step: the diff and clamp, then the
delta's shuffle, then the next owner's downdate (``CHAIN_SOURCE``).
"""

from __future__ import annotations

import argparse
import ctypes
import json
import statistics
import subprocess
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np

# the bench config's w-side block at k = 50 and 100, the engine's h-side
# block at k = 100, a wide rank, and ranks above 224
SHAPES = ((4096, 50), (4096, 100), (2048, 100), (4096, 200), (512, 256),
          (512, 300))
SWEEP_CAP = 32.0
RUNS = 10
ROUNDS = 5
# --wide: B2's packed entry past k = 512 at the sweep cap of phase 10b
# (chip_smoke.py): its 512-column row, the ELL engine's 2,048-cell blocks
# and the bench config's 16,384 genes at k = 600; its 512-column row at k
# = 2,560 (both entries)
WIDE_SHAPES = ((512, 600), (2048, 600), (16384, 600), (512, 2560))
# past this k the old side is the checkout's own warp-a-column kernel
WIDE_OWN_OLD_K = 2048
WIDE_CAP = 8.0
WIDE_ROUNDS = 5
WIDE_RUNS = 3
WIDE_SLOW_MS = 100.0
# the warp-a-column kernel the staged kernel replaced, kept as it was
WIDE_OLD = Path(__file__).resolve().parent / "csrc" / "nnls_wide_warp.cu"


# the CD step's chain on one warp, timed with clock64: variant 0 without
# the shuffle, 1 with it (a half-warp's, as B2's columns of k <= 64), 2
# also with the owner's predicated x update
CHAIN_SOURCE = r"""
#include <cuda_runtime.h>
template <int V>
__global__ void chain(float* out, long long* cyc, int iters) {
  const int lane = threadIdx.x & 31;
  float b = 1.0f + lane, inv = 0.5f, x = 0.25f * lane, g = 1e-3f;
  const long long t0 = clock64();
  for (int it = 0; it < iters; ++it) {
    const int l = it & 15;
    const float diff = __fadd_rn(__fsub_rn(__fmul_rn(b, inv), 0.01f),
                                 __fmul_rn(0.001f, x));
    float d = fmaxf(diff, -x);
    if (V >= 1) d = __shfl_sync(0xffffffffu, d, l, 16);
    if (V >= 2 && (lane & 15) == l) x = __fadd_rn(x, d);
    b = __fsub_rn(b, __fmul_rn(g, d));
  }
  const long long t1 = clock64();
  out[threadIdx.x] = b + x;
  if (threadIdx.x == 0) *cyc = t1 - t0;
}
extern "C" int chain_cycles(int variant, int iters, long long* host) {
  float* out;
  long long* cyc;
  cudaMalloc(&out, 32 * sizeof(float));
  cudaMalloc(&cyc, sizeof(long long));
  if (variant == 0) chain<0><<<1, 32>>>(out, cyc, iters);
  if (variant == 1) chain<1><<<1, 32>>>(out, cyc, iters);
  if (variant == 2) chain<2><<<1, 32>>>(out, cyc, iters);
  const cudaError_t err = cudaMemcpy(host, cyc, sizeof(long long),
                                     cudaMemcpyDeviceToHost);
  cudaFree(out);
  cudaFree(cyc);
  return (int)err;
}
"""


def _chain_cycles(torch) -> dict:
    """Cycles per step of CHAIN_SOURCE's three variants, and the SM clock
    nvidia-smi reads just after."""
    from singlet_tpu_torch import _build

    src = _build.BUILD_DIR / "ab_chain.cu"
    _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    src.write_text(CHAIN_SOURCE)
    lib = _compile(src)
    lib.chain_cycles.argtypes = [ctypes.c_int, ctypes.c_int,
                                 ctypes.POINTER(ctypes.c_longlong)]
    lib.chain_cycles.restype = ctypes.c_int
    iters, out = 100000, {}
    for variant, name in enumerate(("arithmetic", "with_shuffle",
                                    "with_shuffle_and_x")):
        for _ in range(2):   # the first launch warms up
            cyc = ctypes.c_longlong()
            if lib.chain_cycles(variant, iters, ctypes.byref(cyc)):
                raise RuntimeError("chain_cycles failed")
        out[name] = cyc.value / iters
    out["sm_clock"] = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.sm", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    return out


def _compile(src: Path) -> ctypes.CDLL:
    from singlet_tpu_torch import _build

    lib = _build.BUILD_DIR / f"ab_{_build.source_digest(src)[:16]}.so"
    if not lib.is_file():
        _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
        subprocess.run([_build.find_nvcc(), *_build.NVCC_FLAGS, "-o",
                        str(lib), str(src)], check=True, capture_output=True)
    return ctypes.CDLL(str(lib))


def takes_l1(src: Path) -> bool:
    """Whether a source's entries take the (n, k) L1 pointer after the
    mask (ops/nnls_cuda.py's argument types); older sources do not."""
    return b"const uint8_t* mask, const float* l1" in src.read_bytes()


def takes_counts(src: Path) -> bool:
    """Whether a source's entries take the counters' pointer before the
    stream (ops/nnls_cuda.py's argument types); older sources do not."""
    return b"unsigned long long* counts" in src.read_bytes()


def _bind(lib, l1: bool, counts: bool = True):
    """(tile entry, packed entry or None, whether they take the L1
    pointer, whether they take the counters' pointer) of a built
    source."""
    from singlet_tpu_torch.ops.nnls_cuda import _ARGTYPES, _ARGTYPES_PACKED

    # without the counters' pointer: one pointer fewer before the stream;
    # without the L1 pointer: one pointer fewer before the 8 scalars
    def drop(t):
        t = t if counts else t[:-2] + t[-1:]
        return t if l1 else t[:-9 - counts] + t[-8 - counts:]
    fn = lib.nnls_cd_batched
    fn.argtypes = drop(_ARGTYPES)
    fn.restype = ctypes.c_int
    packed = getattr(lib, "nnls_cd_batched_packed", None)
    if packed is not None:
        packed.argtypes = drop(_ARGTYPES_PACKED)
        packed.restype = ctypes.c_int
    return fn, packed, l1, counts


def packed_corrections(torch, F, m, iu):
    """(npairs, n) packed corrections of each column's held-out rows m[c]
    of F, a column at a time: what a masked half-update's ``mask_dot_t``
    of the packed outer products holds, summed in another order (past k =
    2048 the outer products of 2 k rows would take tens of GB)."""
    i, j = (torch.as_tensor(x, device=F.device) for x in iu)
    out = torch.empty((i.numel(), m.shape[0]), device=F.device)
    for c in range(m.shape[0]):
        Fh = F[m[c]]
        out[:, c] = (Fh.T @ Fh)[i, j]
    return out


def _inputs(torch, n: int, k: int, seed: int):
    """(a_full, packed_t, iu, B, X0, mask): a masked half-update's
    solve inputs."""
    from singlet_tpu_torch.ops import linalg

    gen = torch.Generator(device="cuda").manual_seed(seed)
    m_rows = 2 * k
    F = torch.rand((m_rows, k), generator=gen, device="cuda")
    iu = linalg.triu_pairs(k)
    m = torch.rand((n, m_rows), generator=gen, device="cuda") < 0.05
    if k > WIDE_OWN_OLD_K:
        packed_t = packed_corrections(torch, F, m, iu)
    else:
        packed_t = linalg.mask_dot_t(linalg.packed_outer_products(F, iu), m,
                                     1).contiguous()
    a_full = F.T @ F + 1e-15 * torch.eye(k, device="cuda")
    B = torch.where(m, 0.0, torch.rand((n, m_rows), generator=gen,
                                       device="cuda")) @ F
    X0 = (torch.rand((n, k), generator=gen, device="cuda")
          * (torch.rand((n, k), generator=gen, device="cuda") < 0.5))
    mask = torch.rand(n, generator=gen, device="cuda") >= 0.05
    return a_full, packed_t, iu, B.contiguous(), X0, mask


def _turns(torch, fns, call):
    """Per name, the median of RUNS calls of each turn, in the order old,
    new, new, old, ROUNDS times."""
    turns = {name: [] for name in fns}
    for _ in range(ROUNDS):
        for name in ("old", "new", "new", "old"):
            times = []
            for _ in range(RUNS):
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                start.record()
                call(name)
                end.record()
                torch.cuda.synchronize()
                times.append(start.elapsed_time(end))
            turns[name].append(statistics.median(times))
    return {"old_ms": turns["old"], "new_ms": turns["new"],
            "old_median_ms": statistics.median(turns["old"]),
            "new_median_ms": statistics.median(turns["new"])}


def card_line() -> str:
    """The card's name and power limit, as nvidia-smi prints them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]


def wide_turns(torch, call, old_first_ms: float) -> dict:
    """``call(name)`` timed in turns old, new, new, old: WIDE_ROUNDS
    rounds, a turn the median of WIDE_RUNS single calls by CUDA events
    (one call where the old side's first call took longer than
    WIDE_SLOW_MS). Every turn's time, the medians over the turns, each
    side's range (min, max) over them and new over old."""
    slow = old_first_ms > WIDE_SLOW_MS
    rounds, runs = WIDE_ROUNDS, (1 if slow else WIDE_RUNS)
    turns = {"old": [], "new": []}
    for _ in range(rounds):
        for name in ("old", "new", "new", "old"):
            times = []
            for _ in range(runs):
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                start.record()
                call(name)
                end.record()
                torch.cuda.synchronize()
                times.append(start.elapsed_time(end))
            turns[name].append(statistics.median(times))
    old, new = (statistics.median(turns[v]) for v in ("old", "new"))
    return {"old_ms": turns["old"], "new_ms": turns["new"],
            "old_median_ms": old, "new_median_ms": new,
            "old_range_ms": [min(turns["old"]), max(turns["old"])],
            "new_range_ms": [min(turns["new"]), max(turns["new"])],
            "ratio": new / old, "rounds": rounds, "runs": runs}


def timed_once(torch, fn) -> float:
    """One call of fn by CUDA events, ms."""
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end)


def warp_plan(n: int, k: int):
    """(warps, blocks) of the warp-a-column kernel's shared-memory route,
    as its plan gave them before the staged kernel (csrc/nnls_wide_warp.cu
    takes them)."""
    warps = min(8, 232448 // (8 * k))
    return warps, -(-n // warps)


# the packed wide entry of a source before the staged kernel: a_full,
# packed_t, row starts, B, X0, mask, l1, X, scratch, then n, k, warps,
# blocks, L1, L2, k_div, cap, max_sweeps and the stream
_OLD_WIDE_ARGTYPES = ([ctypes.c_void_p] * 9 + [ctypes.c_int] * 4
                      + [ctypes.c_float] * 4
                      + [ctypes.c_int, ctypes.c_void_p])


def run_wide(torch, old_src=None, shapes=WIDE_SHAPES, card=None,
             plain_cols: int = 0) -> list:
    """B2's wide entries, the checkout's staged kernel against the
    warp-a-column kernel it replaced (up to k = 2048 ``old_src``'s,
    default ``WIDE_OLD``; past it the checkout's ``wide_kernel`` forced by
    its plan), per (n, k) of ``shapes`` in turns (``wide_turns``) on a
    masked half-update's inputs (``_inputs``): the packed entry, and past
    k = 2048 the tile entry on the unpacked Grams too, the same bits; with
    ``plain_cols``, the output's first columns (at most 64 past k = 2048)
    also within the B2 gate (rtol 5e-3, atol 1e-6) of the plain version on
    their unpacked Grams. Returns one dict a shape and entry, each printed
    as a JSON line."""
    from singlet_tpu_torch.ops import linalg, nnls, nnls_cuda
    from singlet_tpu_torch.ops.nnls import CD_MAX_SWEEPS

    card = card or card_line()
    old_src = Path(old_src or WIDE_OLD)
    new_fn, _ = nnls_cuda._kernel("nnls_wide", "nnls_wide_b2_packed",
                                  nnls_cuda.ARGTYPES_B2_PACKED_WIDE)
    tile_fn, _ = nnls_cuda._kernel("nnls_wide", "nnls_wide_b2",
                                   nnls_cuda.ARGTYPES_B2_WIDE)
    old_fn = _compile(old_src).nnls_cd_batched_packed_wide
    old_fn.argtypes = _OLD_WIDE_ARGTYPES
    old_fn.restype = ctypes.c_int
    stream = torch.cuda.current_stream().cuda_stream
    rows = []
    for n, k in shapes:
        a_full, packed_t, iu, B, X0, mask = _inputs(torch, n, k, seed=n + k)
        a_pad = nnls_cuda._padded_rows(a_full)
        starts = torch.as_tensor(nnls_cuda.packed_row_starts(k, iu),
                                 device="cuda")
        plan = nnls_cuda.nnls_wide_plan(n, k)
        warps, blocks = warp_plan(n, k)
        own_old = k > WIDE_OWN_OLD_K
        tail = (0.01, 0.001, float(k), WIDE_CAP, CD_MAX_SWEEPS)
        entries = {"packed": (new_fn, (a_pad, packed_t, starts))}
        if own_old:
            at = linalg.unpack_sym_from_t(packed_t, k, iu,
                                          a_full).contiguous()
            inv_diag = (1.0 / at.reshape(k * k, n)[:: k + 1]).contiguous()
            entries["tile"] = (tile_fn, (at, inv_diag))
        outs = {name: torch.empty_like(B) for name in ("old", "new")}
        bits = None
        for entry, (fn, grams) in entries.items():

            def call(name, fn=fn, grams=grams):
                X = outs[name]
                head = (B.data_ptr(), X0.data_ptr(), mask.data_ptr(), None,
                        X.data_ptr(), None, n, k)
                ptrs = tuple(t.data_ptr() for t in grams)
                if name == "new":
                    err = fn(*ptrs, *head, plan.warps, plan.blocks,
                             plan.depth, plan.lanes, *tail, None, stream)
                elif own_old:
                    err = fn(*ptrs, *head, warps, blocks, 0, 32, *tail,
                             None, stream)
                else:
                    err = old_fn(a_full.data_ptr(), packed_t.data_ptr(),
                                 starts.data_ptr(), *head, warps, blocks,
                                 *tail, stream)
                if err:
                    raise RuntimeError(f"B2 wide {entry} ({name}) n={n} "
                                       f"k={k}: {err}")

            for name in outs:
                outs[name].fill_(float("nan"))
            old_first = timed_once(torch, lambda: call("old"))
            call("new")
            torch.cuda.synchronize()
            if not torch.equal(outs["old"], outs["new"]):
                raise AssertionError(f"B2 wide {entry} n={n} k={k}: the two "
                                     "versions differ")
            if bits is None:
                bits = outs["new"].clone()
            elif not torch.equal(bits, outs["new"]):
                raise AssertionError(f"B2 wide n={n} k={k}: the entries "
                                     "differ")
            row = {"kernel": "B2-wide", "entry": entry, "n": n, "k": k,
                   "sweep_cap": WIDE_CAP,
                   "old": ("nnls_wide.cuh wide_kernel" if own_old
                           else old_src.name),
                   "plan": plan._asdict(), "card": card, "same_bits": True,
                   **wide_turns(torch, call, old_first)}
            print(json.dumps(row), flush=True)
            rows.append(row)
        if plain_cols:
            c = min(n, plain_cols, 64 if own_old else plain_cols)
            at_c = linalg.unpack_sym_from_t(packed_t[:, :c].contiguous(), k,
                                            iu, a_full)
            want = nnls.nnls_batch(at_c.permute(2, 1, 0), B[:c], X0[:c],
                                   L1=0.01, L2=0.001, update_mask=mask[:c],
                                   sweep_cap=WIDE_CAP)
            got = bits[:c]
            np.testing.assert_allclose(got.cpu().numpy(),
                                       want.cpu().numpy(), rtol=5e-3,
                                       atol=1e-6)
            for row in rows[-len(entries):]:
                row["plain_cols"] = c
                row["max_abs_err"] = float((got - want).abs().max())
            print(json.dumps({"kernel": "B2-wide", "n": n, "k": k,
                              "plain_cols": c,
                              "max_abs_err": rows[-1]["max_abs_err"]}),
                  flush=True)
            del at_c, want
        del a_full, a_pad, packed_t, B, X0, mask, outs, entries, bits
        torch.cuda.empty_cache()
    return rows


def main() -> int:
    import torch

    from singlet_tpu_torch.ops import linalg, nnls_cuda
    from singlet_tpu_torch.ops.nnls import CD_MAX_SWEEPS

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--wide", action="store_true",
                    help="B2's wide-k route against OLD's (default "
                         "csrc/nnls_wide_warp.cu)")
    ap.add_argument("old", type=Path, nargs="?")
    ap.add_argument("new", type=Path, nargs="?")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("ab_nnls_batched needs a CUDA device")
    card = card_line()
    if args.wide:
        run_wide(torch, args.old, card=card, plain_cols=512)
        return 0
    if args.old is None or args.new is None:
        ap.error("OLD.cu and NEW.cu are needed without --wide")
    with ThreadPoolExecutor(2) as pool:
        libs = list(pool.map(_compile, (args.old, args.new)))
    fns = {name: _bind(lib, takes_l1(src), takes_counts(src))
           for name, lib, src in zip(("old", "new"), libs,
                                     (args.old, args.new))}
    if fns["new"][1] is None:
        raise SystemExit(f"{args.new} has no nnls_cd_batched_packed")
    print(json.dumps({"chain": _chain_cycles(torch), "card": card}),
          flush=True)
    stream = torch.cuda.current_stream().cuda_stream

    def check(err, what):
        if err:
            raise RuntimeError(f"{what} failed: {err}")

    for n, k in SHAPES:
        a_full, packed_t, iu, B, X0, mask = _inputs(torch, n, k, seed=n + k)
        starts = torch.as_tensor(nnls_cuda.packed_row_starts(k, iu),
                                 device="cuda")
        scalars = (n, k, 0.01, 0.001, float(k), SWEEP_CAP, CD_MAX_SWEEPS)
        outs = {name: torch.empty_like(B) for name in fns}

        def tail(name):
            """The scalars, the null counters' pointer where the entry
            takes one, and the stream."""
            return scalars + ((None,) if fns[name][3] else ()) + (stream,)

        def ptrs(name):
            """The mask, the scalar L1's null L1 pointer where the entry
            takes one, and the output."""
            return ((mask.data_ptr(),) + ((None,) if fns[name][2] else ())
                    + (outs[name].data_ptr(),))

        def tile(name, at, inv_diag):
            check(fns[name][0](at.data_ptr(), inv_diag.data_ptr(),
                               B.data_ptr(), X0.data_ptr(), *ptrs(name),
                               *tail(name)),
                  f"nnls_cd_batched ({name})")

        def solve(name):
            """The masked solve from a_full and packed_t: the old source
            on the unpacked tile, the new one on the packed form."""
            if name == "old":
                at = linalg.unpack_sym_from_t(packed_t, k, iu, a_full)
                tile(name, at, 1.0 / at.reshape(k * k, n)[:: k + 1])
                return
            check(fns[name][1](a_full.data_ptr(), packed_t.data_ptr(),
                               starts.data_ptr(), B.data_ptr(), X0.data_ptr(),
                               *ptrs(name), *tail(name)),
                  "nnls_cd_batched_packed (new)")

        at = linalg.unpack_sym_from_t(packed_t, k, iu, a_full).contiguous()
        inv_diag = (1.0 / at.reshape(k * k, n)[:: k + 1]).contiguous()
        row = {"n": n, "k": k, "sweep_cap": SWEEP_CAP, "card": card,
               "same_bits": True}
        for label, call in (("at", lambda name: tile(name, at, inv_diag)),
                            ("packed", solve)):
            for name in fns:
                outs[name].fill_(float("nan"))
                call(name)
            torch.cuda.synchronize()
            if not torch.equal(outs["old"], outs["new"]):
                raise AssertionError(f"n={n} k={k} {label}: the two "
                                     "versions differ")
            row[label] = _turns(torch, fns, call)
        del at
        print(json.dumps(row), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())

"""Time two versions of kernels B3 and B5 (``csrc/bell_spmm.cu``'s
``bell_spmm``) against each other on one CUDA card, in turns, on the same
inputs.

    python3 -m singlet_tpu_torch.ab_bell_spmm OLD.cu [NEW.cu]
    python3 -m singlet_tpu_torch.ab_bell_spmm --wide

With ``--wide``: the wide-block route (``bell_spmm_wide``, through
``ops/bell_cuda.py``'s wrapper) against the one-warp-per-cell kernel it
replaced (``csrc/bell_spmm_wide_warp.cu``, ``wide_warp``), on
``chip_smoke.py``'s phase 10c planes (16,384 genes in two gene blocks of
8,192, 4,096 cells, width 416) at k = 50 and 100 in keep modes 0, 1 and 2,
the same bits on every row, turns as below.

OLD.cu is the one-warp-per-cell source of commit b779cfe
(``git show b779cfe:singlet_tpu_torch/csrc/bell_spmm.cu >
build/old_bell_spmm.cu``): its ``bell_spmm`` takes at most 224 columns of W
a launch, so above that the old side runs what that commit's wrapper ran,
W in column chunks of 224 (a contiguous copy of each chunk, a launch into
a chunk of B and a copy back), timed with the chunks. NEW.cu (default the
checkout's ``csrc/bell_spmm.cu``) takes the plan of ``ops/bell_cuda.py``
``b3_plan`` and one launch. Both are compiled with ``_build``'s nvcc flags,
started together, into the git-ignored ``build/``. Run from the root of a
checkout: the operands are ``chip_smoke.py``'s.

Shapes (``SHAPES``): the 524,288 x 16,384 operand of
``benchmarks/largescale.py`` generated on the card (width 32, gene_block
512): its 8192-cell slice at cell 262,144 and the first 2048-cell block of
that slice at k = 100, and all its cells at k = 100 (the plain step's
call); the bench operand's ELL planes (16,384 x 8192, 7% dense, width 72,
gene_block 512) at k = 50, 256 and 300. Keep modes: 0 (B3), 1 (B3 with the
hashed test mask, seed 1, inv_density 20) and 2 (B5 on the same mask
packed into bitplane words); the full call in mode 0 alone, as the plain
step runs it. Each turn times one version as the median of ``RUNS`` calls
by CUDA events, in the order old, new, new, old repeated ``ROUNDS`` times.
The two versions' outputs must be equal bit for bit, and B5 equal to mode
1. Prints one JSON line per (shape, mode) with every turn's time, the
ratio of the medians (new over old) and the card's name and power limit.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import statistics
import subprocess
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

from singlet_tpu_torch.ab_nnls_batched import _compile

RUNS = 10
ROUNDS = 3
MASK_SEED, INV_DENSITY = 1, 20
# (label, operand, first cell, cells or None for all, k, keep modes)
SHAPES = (("slice", "large", 262144, 8192, 100, (0, 1, 2)),
          ("block", "large", 262144, 2048, 100, (0, 1, 2)),
          ("bench", "bench", 0, None, 50, (0, 1, 2)),
          ("bench", "bench", 0, None, 256, (0, 1, 2)),
          ("bench", "bench", 0, None, 300, (0, 1, 2)),
          ("all cells", "large", 0, None, 100, (0,)))
# the old source's widest launch: its wrapper split W into chunks of this
OLD_K_CHUNK = 224

# the old source's bell_spmm: planes, ld, n_gb, width, cells, gene_block,
# W, k, B, keep mode, seed, cell offset, inv_density, words, words' row
# stride, stream
_VP, _CI, _CL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
_OLD_ARGTYPES = [_VP, _VP, _CL, _CI, _CI, _CI, _CI, _VP, _CI, _VP, _CI,
                 ctypes.c_uint64, _CL, _CI, _VP, _CL, _VP]


# csrc/bell_spmm_wide_warp.cu's bell_spmm_wide: planes, ld, n_gb, width,
# cells, gene_block, W, its row stride, k, B, keep mode, seed, cell
# offset, inv_density, words, words' row stride, stream
WARP_ARGTYPES = [_VP, _VP, _CL, _CI, _CI, _CI, _CI, _VP, _CL, _CI, _VP,
                 _CI, ctypes.c_uint64, _CL, _CI, _VP, _CL, _VP]
# --wide: phase 10c's planes, (k, keep modes)
WIDE_KS = (50, 100)


def wide_warp(torch):
    """The one-warp-per-cell wide-block kernel of B3/B5
    (``csrc/bell_spmm_wide_warp.cu``), built at first use and bound: a
    function ``(b_li, b_val, W, mode, seed64, cell_offset, inv_density,
    words, gene_block) -> B`` that launches it once on the current
    stream."""
    from singlet_tpu_torch import _build

    fn = _build.load("bell_spmm_wide_warp").bell_spmm_wide
    fn.argtypes = WARP_ARGTYPES
    fn.restype = _CI

    def call(li, lv, W, mode, seed64, cell_offset, inv_density, words,
             gene_block):
        n_gb, k = W.shape[0] // gene_block, W.shape[1]
        cells = li.shape[1]
        B = torch.empty((cells, k), dtype=torch.float32, device=W.device)
        err = fn(li.data_ptr(), lv.data_ptr(), li.stride(0), n_gb,
                 li.shape[0] // n_gb, cells, gene_block, W.data_ptr(),
                 W.stride(0), k, B.data_ptr(), mode, seed64,
                 int(cell_offset), int(inv_density),
                 None if words is None else words.data_ptr(),
                 0 if words is None else words.stride(0),
                 torch.cuda.current_stream(W.device).cuda_stream)
        if err:
            raise RuntimeError(f"bell_spmm_wide_warp launch failed ({err})")
        return B

    return call


def main_wide(torch, card) -> int:
    """``--wide``: the wide-block route against ``wide_warp`` in turns."""
    import chip_smoke

    from singlet_tpu_torch.ops import bell_cuda
    from singlet_tpu_torch.ops.rngmask import seed_pair

    P = chip_smoke.WIDE_BLOCK
    G, cells = P["gene_block"], P["cells"]
    li, lv, width = chip_smoke.synth_bell_planes_torch(
        P["genes"], cells, P["nnz"], G)
    words = chip_smoke._slice_words(torch, 0, cells, P["genes"], G)
    old = wide_warp(torch)
    seed = seed_pair(MASK_SEED)
    _, seed64 = bell_cuda._seed_args(seed, INV_DENSITY)
    for k in WIDE_KS:
        gen = torch.Generator(device="cuda").manual_seed(k)
        W = torch.rand((P["genes"], k), generator=gen, device="cuda")
        outs = {}
        for mode in (0, 1, 2):
            new = {0: lambda: bell_cuda.bell_spmm_cuda(li, lv, W,
                                                       gene_block=G),
                   1: lambda: bell_cuda.bell_spmm_cuda(
                       li, lv, W, seed, 0, gene_block=G,
                       inv_density=INV_DENSITY),
                   2: lambda: bell_cuda.bell_spmm_bits_cuda(
                       li, lv, W, words, gene_block=G)}[mode]
            args = ((0, 0, 0, 1, None), (1, seed64, 0, INV_DENSITY, None),
                    (2, 0, 0, 1, words))[mode]
            calls = {"old": lambda a=args: old(li, lv, W, *a, G),
                     "new": new}
            if not torch.equal(calls["old"](), calls["new"]()):
                raise AssertionError(f"wide k={k} mode={mode}: the two "
                                     "versions differ")
            outs[mode] = calls["new"]()
            row = {"shape": "wide block", "cells": cells, "k": k,
                   "width": width, "gene_block": G, "mode": mode,
                   "kernel": "B5" if mode == 2 else "B3",
                   "plan": bell_cuda.b3_plan(cells, 2, G, width, k,
                                             mode == 2)._asdict(),
                   "same_bits": True, "card": card,
                   **_turns(torch, lambda name: calls[name]())}
            print(json.dumps(row), flush=True)
        if not torch.equal(outs[1], outs[2]):
            raise AssertionError(f"wide k={k}: B5 differs from masked B3")
    return 0


def _bind(lib, new: bool):
    """A library's bell_spmm with its argument types: the old source's, or
    those of ops/bell_cuda.py for the new."""
    from singlet_tpu_torch.ops.bell_cuda import ARGTYPES_B3

    fn = lib.bell_spmm
    fn.argtypes = ARGTYPES_B3 if new else _OLD_ARGTYPES
    fn.restype = _CI
    return fn


def _operands(torch, which: str):
    """(b_li, b_val, gene_block, n_gb) of ``chip_smoke.py``'s large or
    bench operand, on the card."""
    import chip_smoke

    if which == "large":
        L = chip_smoke.LARGE
        li, lv, _ = chip_smoke.synth_bell_planes_torch(
            L["genes"], L["cells"], L["nnz"], L["gene_block"])
        return li, lv, L["gene_block"], L["genes"] // L["gene_block"]
    import scipy.sparse as sp

    from singlet_tpu_torch.parallel.sharded_ell import shard_ell_data

    A, _ = chip_smoke._bench_operand()
    data = shard_ell_data(sp.csc_matrix(A), device="cuda")
    return data.b_li, data.b_val, data.gene_block, data.n_gb


def _turns(torch, call):
    """Per version, the median of RUNS calls of each turn, in the order
    old, new, new, old, ROUNDS times."""
    turns = {"old": [], "new": []}
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
    old, new = (statistics.median(turns[n]) for n in ("old", "new"))
    return {"old_ms": turns["old"], "new_ms": turns["new"],
            "old_median_ms": old, "new_median_ms": new, "ratio": new / old}


def main() -> int:
    import torch

    from singlet_tpu_torch import _build
    from singlet_tpu_torch.ops.bell_cuda import (_padded, _seed_args,
                                                _tma_ready, b3_bm_words,
                                                b3_plan)
    from singlet_tpu_torch.ops.maskbits import pack_mask_words
    from singlet_tpu_torch.ops.rngmask import seed_pair

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("old", type=Path, nargs="?")
    ap.add_argument("new", type=Path, nargs="?",
                    default=_build.CSRC_DIR / "bell_spmm.cu")
    ap.add_argument("--wide", action="store_true",
                    help="the wide-block route against wide_warp")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("ab_bell_spmm needs a CUDA device")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    if args.wide:
        return main_wide(torch, card)
    if args.old is None:
        ap.error("OLD.cu is required without --wide")
    with ThreadPoolExecutor(2) as pool:
        old_lib, new_lib = pool.map(_compile, (args.old, args.new))
    fns = {"old": _bind(old_lib, False), "new": _bind(new_lib, True)}
    stream = torch.cuda.current_stream().cuda_stream
    seed = seed_pair(MASK_SEED)
    _, seed64 = _seed_args(seed, INV_DENSITY)

    def check(err, what):
        if err:
            raise RuntimeError(f"{what} failed: {err}")

    operands = {}
    for label, which, c0, n, k, modes in SHAPES:
        if which not in operands:
            operands.clear()
            torch.cuda.empty_cache()
            operands[which] = _operands(torch, which)
        li_all, lv_all, G, n_gb = operands[which]
        n = li_all.shape[1] - c0 if n is None else n
        li, lv = li_all[:, c0:c0 + n], lv_all[:, c0:c0 + n]
        width = li.shape[0] // n_gb
        gen = torch.Generator(device="cuda").manual_seed(k)
        W = torch.rand((n_gb * G, k), generator=gen, device="cuda")
        words = None
        if 2 in modes:
            words = pack_mask_words(
                seed, torch.arange(c0, c0 + n, device="cuda"),
                genes_pad=n_gb * G, gene_block=G, inv_density=INV_DENSITY,
                cells_true=c0 + n, genes_true=n_gb * G)
        outs = {}
        for mode in modes:
            plan = b3_plan(n, n_gb, G, width, k, mode == 2)
            bm = (torch.empty(n_gb * b3_bm_words(G) * (-(-n // 4) * 4),
                              dtype=torch.int32, device="cuda")
                  if mode == 2 else None)
            tail = dict(mode=mode, seed=seed64 if mode == 1 else 0,
                        offset=c0 if mode == 1 else 0,
                        inv=INV_DENSITY if mode == 1 else 1,
                        words=words.data_ptr() if mode == 2 else None,
                        wld=words.stride(0) if mode == 2 else 0)
            B = {name: torch.empty((n, k), device="cuda") for name in fns}

            def launch(fn, Wc, kc, Bc, t=tail):
                check(fn(li.data_ptr(), lv.data_ptr(), li.stride(0), n_gb,
                         width, n, G, Wc.data_ptr(), kc, Bc.data_ptr(),
                         t["mode"], t["seed"], t["offset"], t["inv"],
                         t["words"], t["wld"], stream), "bell_spmm")

            def call(name, B=B, t=tail, plan=plan, bm=bm):
                if name == "new":
                    # what ops/bell_cuda.py's wrapper launches
                    Wt = W if _tma_ready(W) else _padded(W)
                    check(fns["new"](
                        li.data_ptr(), lv.data_ptr(), li.stride(0), n_gb,
                        width, n, G, Wt.data_ptr(), Wt.stride(0), k,
                        B["new"].data_ptr(), plan.kt, plan.rounds, plan.win,
                        plan.cs, t["mode"], t["seed"], t["offset"], t["inv"],
                        t["words"], t["wld"],
                        None if bm is None else bm.data_ptr(), stream),
                      "bell_spmm")
                    return
                if k <= OLD_K_CHUNK:
                    launch(fns["old"], W, k, B["old"])
                    return
                # the old wrapper: W in column chunks of 224, one launch
                # each into a chunk of B, copied back
                for j0 in range(0, k, OLD_K_CHUNK):
                    kc = min(OLD_K_CHUNK, k - j0)
                    Bc = torch.empty((n, kc), device="cuda")
                    launch(fns["old"], W[:, j0:j0 + kc].contiguous(), kc, Bc)
                    B["old"][:, j0:j0 + kc] = Bc

            for name in fns:
                B[name].fill_(float("nan"))
                call(name)
            torch.cuda.synchronize()
            if not torch.equal(B["old"], B["new"]):
                raise AssertionError(f"{label} k={k} mode={mode}: the two "
                                     "versions differ")
            outs[mode] = B["new"]
            row = {"shape": label, "cells": n, "k": k, "width": width,
                   "gene_block": G, "mode": mode, "kernel":
                   "B5" if mode == 2 else "B3", "plan": plan._asdict(),
                   "same_bits": True, "card": card, **_turns(torch, call)}
            print(json.dumps(row), flush=True)
        if 1 in outs and 2 in outs and not torch.equal(outs[1], outs[2]):
            raise AssertionError(f"{label} k={k}: B5 differs from masked B3")
        del W, words, outs
    return 0


if __name__ == "__main__":
    raise SystemExit(main())

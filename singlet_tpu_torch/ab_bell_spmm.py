"""Time two versions of kernels B3 and B5 (``csrc/bell_spmm.cu``'s
``bell_spmm``) against each other on one CUDA card, in turns, on the same
inputs.

    python3 -m singlet_tpu_torch.ab_bell_spmm OLD.cu [NEW.cu]

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
    ap.add_argument("old", type=Path)
    ap.add_argument("new", type=Path, nargs="?",
                    default=_build.CSRC_DIR / "bell_spmm.cu")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("ab_bell_spmm needs a CUDA device")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
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

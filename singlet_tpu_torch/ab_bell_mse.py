"""Time two versions of kernel B7 (``csrc/bell_mse_bits.cu``) against each
other on one CUDA card, in turns, on the same inputs.

    python3 -m singlet_tpu_torch.ab_bell_mse OLD.cu [NEW.cu]

OLD.cu is the one-warp-per-cell source of commit fb6bcee (``git show
fb6bcee:singlet_tpu_torch/csrc/bell_mse_bits.cu >
build/old_bell_mse_bits.cu``), which reads Wd as it is. NEW.cu (default the
checkout's ``csrc/bell_mse_bits.cu``) takes the plan of ``ops/bell_cuda.py``
``b7_plan`` and Wd permuted by ``b7_wd_operand``, made in each timed call
as the wrapper makes it; its entry runs the test-bit pass and the kernel.
Both are compiled with ``_build``'s nvcc flags, started together, into the
git-ignored ``build/``. Run from the root of a checkout: the operands are
``chip_smoke.py``'s.

Shapes (``SHAPES``): the 524,288 x 16,384 operand of
``benchmarks/largescale.py`` generated on the card (width 32, gene_block
512): its 8192-cell slice at cell 262,144 and all its cells at k = 100 (the
bits route's test MSE); the bench operand's ELL planes (16,384 x 8192, 7%
dense, width 72, gene_block 512) at k = 50, 256 and 300. The test mask is
``chip_smoke.py``'s (seed 1, inv_density 20) packed into bitplane words; Wd
= W / k and H uniform in [0, 1). Each turn times one version as the median
of ``RUNS`` calls by CUDA events, in the order old, new, new, old repeated
``ROUNDS`` times. The two versions' outputs must be equal bit for bit.
Prints one JSON line per shape with every turn's time, the ratio of the
medians (new over old), the plan and the card's name and power limit.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import statistics
import subprocess
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

from singlet_tpu_torch.ab_bell_spmm import _operands
from singlet_tpu_torch.ab_nnls_batched import _compile

RUNS = 5
ROUNDS = 3
MASK_SEED, INV_DENSITY = 1, 20
# (label, operand, first cell, cells or None for all, k)
SHAPES = (("slice", "large", 262144, 8192, 100),
          ("all cells", "large", 0, None, 100),
          ("bench", "bench", 0, None, 50),
          ("bench", "bench", 0, None, 256),
          ("bench", "bench", 0, None, 300))

_VP, _CI, _CL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
# the old source's bell_mse_bits: planes, ld, n_gb, width, cells,
# gene_block, words, words' row stride, Wd, H, k, out, stream
_OLD_ARGTYPES = [_VP, _VP, _CL, _CI, _CI, _CI, _CI, _VP, _CL, _VP, _VP, _CI,
                 _VP, _VP]


def _bind(lib, new: bool):
    """A library's bell_mse_bits with its argument types: the old source's,
    or those of ops/bell_cuda.py for the new."""
    fn = lib.bell_mse_bits
    if new:
        vp, ci, cl = _VP, _CI, _CL
        fn.argtypes = [vp, vp, cl, ci, ci, ci, ci, vp, cl, vp, vp, ci, ci,
                       ci, ci, ci, vp, ci, ci, vp, vp]
    else:
        fn.argtypes = _OLD_ARGTYPES
    fn.restype = _CI
    return fn


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
    from singlet_tpu_torch.ops.bell_cuda import b7_plan, b7_wd_operand
    from singlet_tpu_torch.ops.maskbits import pack_mask_words
    from singlet_tpu_torch.ops.rngmask import seed_pair

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("old", type=Path)
    ap.add_argument("new", type=Path, nargs="?",
                    default=_build.CSRC_DIR / "bell_mse_bits.cu")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("ab_bell_mse needs a CUDA device")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    with ThreadPoolExecutor(2) as pool:
        old_lib, new_lib = pool.map(_compile, (args.old, args.new))
    fns = {"old": _bind(old_lib, False), "new": _bind(new_lib, True)}
    stream = torch.cuda.current_stream().cuda_stream
    seed = seed_pair(MASK_SEED)

    def check(err, what):
        if err:
            raise RuntimeError(f"{what} failed: {err}")

    operands = {}
    for label, which, c0, n, k in SHAPES:
        if which not in operands:
            operands.clear()
            torch.cuda.empty_cache()
            operands[which] = _operands(torch, which)
        li_all, lv_all, G, n_gb = operands[which]
        n = li_all.shape[1] - c0 if n is None else n
        li, lv = li_all[:, c0:c0 + n], lv_all[:, c0:c0 + n]
        width = li.shape[0] // n_gb
        genes = n_gb * G
        gen = torch.Generator(device="cuda").manual_seed(k + 1)
        Wd = torch.rand((genes, k), generator=gen, device="cuda") / k
        H = torch.rand((n, k), generator=gen, device="cuda")
        words = pack_mask_words(
            seed, torch.arange(c0, c0 + n, device="cuda"), genes_pad=genes,
            gene_block=G, inv_density=INV_DENSITY, cells_true=c0 + n,
            genes_true=genes)
        plan = b7_plan(n, n_gb, G, width, k)
        cells_pad = plan.n_ct * plan.cells
        bm = torch.empty(n_gb * cells_pad * plan.bm_pitch, dtype=torch.int32,
                         device="cuda")
        outs = {name: torch.empty((2, n), device="cuda") for name in fns}

        def call(name):
            out = outs[name]
            if name == "old":
                check(fns["old"](li.data_ptr(), lv.data_ptr(), li.stride(0),
                                 n_gb, width, n, G, words.data_ptr(),
                                 words.stride(0), Wd.data_ptr(),
                                 H.data_ptr(), k, out.data_ptr(), stream),
                      "bell_mse_bits (old)")
                return
            wp = b7_wd_operand(Wd, plan.npl)   # as the wrapper does
            check(fns["new"](li.data_ptr(), lv.data_ptr(), li.stride(0),
                             n_gb, width, n, G, words.data_ptr(),
                             words.stride(0), wp.data_ptr(), H.data_ptr(),
                             k, plan.npl, plan.cpw, plan.walkers, plan.rows,
                             bm.data_ptr(), cells_pad, plan.bm_pitch,
                             out.data_ptr(), stream), "bell_mse_bits (new)")

        for name in fns:
            outs[name].fill_(float("nan"))
            call(name)
        torch.cuda.synchronize()
        if not torch.equal(outs["old"], outs["new"]):
            bad = int((outs["old"] != outs["new"]).any(dim=0).sum())
            raise AssertionError(f"{label} k={k}: {bad} cells differ")
        row = {"shape": label, "cells": n, "k": k, "width": width,
               "gene_block": G, "held_out": int(outs["new"][1].sum()),
               "plan": plan._asdict(), "same_bits": True, "card": card,
               **_turns(torch, call)}
        print(json.dumps(row), flush=True)
        del Wd, H, words, bm, outs
    return 0


if __name__ == "__main__":
    raise SystemExit(main())

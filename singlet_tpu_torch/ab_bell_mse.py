"""Time two versions of kernel B7 (``csrc/bell_mse_bits.cu``) against each
other on one CUDA card, in turns, on the same inputs.

    python3 -m singlet_tpu_torch.ab_bell_mse OLD.cu [NEW.cu]
    python3 -m singlet_tpu_torch.ab_bell_mse --wide [OLD.cu]

``--wide`` times B7's wide route instead (``run_wide``): the checkout's
tiles of cells (``bell_mse_bits_wide`` on the plan of ``ops/bell_cuda.py``
``b7_wide_plan``, the test-bit pass included; past k = 1024 Wd's rows
streamed) against OLD.cu's ``bell_mse_bits_wide``, the warp-a-cell kernel
it replaced (default ``csrc/bell_mse_bits_wide_warp.cu``, that kernel
kept as it was), at the ``WIDE_SHAPES`` past k = 512; and, forced at k <=
512, against the tiled kernel (``bell_mse_bits`` on ``b7_plan``, Wd
permuted in each call as the wrapper does). Each in 5 rounds of turns old, new, new, old, a turn the
median of 3 single calls by CUDA events (``ab_nnls_batched.wide_turns``),
the outputs equal bit for bit; one JSON line per shape with the card's
name and power limit.

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
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

from singlet_tpu_torch.ab_bell_spmm import _operands
from singlet_tpu_torch.ab_nnls_batched import _compile, card_line, wide_turns

RUNS = 5
ROUNDS = 3
MASK_SEED, INV_DENSITY = 1, 20
# (label, operand, first cell, cells or None for all, k)
SHAPES = (("slice", "large", 262144, 8192, 100),
          ("all cells", "large", 0, None, 100),
          ("bench", "bench", 0, None, 50),
          ("bench", "bench", 0, None, 256),
          ("bench", "bench", 0, None, 300))

# --wide: (label, operand, first cell, cells or None for all, k, the old
# side): the bench planes at k = 600 and at the last k of Wd's rows in
# registers, 1024, and past it (streamed) at 1100 and 2560, against the
# warp-a-cell kernel; the bench planes at k = 256, 384 and 512, the wide
# route forced, against the tiled kernel; all 524,288 cells of the large
# operand at k = 600 (H 1.17 GiB) against the warp-a-cell kernel
WIDE_SHAPES = (("bench", "bench", 0, None, 600, "warp"),
               ("bench", "bench", 0, None, 1024, "warp"),
               ("bench", "bench", 0, None, 1100, "warp"),
               ("bench", "bench", 0, None, 2560, "warp"),
               ("bench", "bench", 0, None, 256, "tiled"),
               ("bench", "bench", 0, None, 384, "tiled"),
               ("bench", "bench", 0, None, 512, "tiled"),
               ("all cells", "large", 0, None, 600, "warp"))
# the warp-a-cell kernel the tiles replaced, kept as it was
WIDE_OLD = Path(__file__).resolve().parent / "csrc" / \
    "bell_mse_bits_wide_warp.cu"

_VP, _CI, _CL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong


def _bind(lib, new: bool):
    """A library's bell_mse_bits with its argument types: the old source's,
    or those of ops/bell_cuda.py for the new."""
    from singlet_tpu_torch.ops.bell_cuda import ARGTYPES_B7_WARP

    fn = lib.bell_mse_bits
    if new:
        vp, ci, cl = _VP, _CI, _CL
        fn.argtypes = [vp, vp, cl, ci, ci, ci, ci, vp, cl, vp, vp, ci, ci,
                       ci, ci, ci, vp, ci, ci, vp, vp]
    else:   # the old source's entry takes the warp-a-cell kernel's
        fn.argtypes = ARGTYPES_B7_WARP
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


def warp_kernel(old_src=None):
    """The warp-a-cell kernel's entry of ``old_src`` (default ``WIDE_OLD``,
    built by ``_build`` as the package's sources are), built at first use
    and bound (ops/bell_cuda.py ``ARGTYPES_B7_WARP``)."""
    from singlet_tpu_torch import _build
    from singlet_tpu_torch.ops.bell_cuda import ARGTYPES_B7_WARP

    lib = (_build.load(WIDE_OLD.stem) if old_src is None
           else _compile(Path(old_src)))
    fn = lib.bell_mse_bits_wide
    fn.argtypes = ARGTYPES_B7_WARP
    fn.restype = _CI
    return fn


def run_wide(torch, shapes=WIDE_SHAPES, card=None, old_src=None,
             planes=None) -> list:
    """B7's wide route on its tiles of cells against the warp-a-cell kernel
    of ``old_src`` (``warp_kernel``) or, where a shape says "tiled", the
    tiled kernel, per shape of ``shapes`` in turns (``wide_turns``), the
    same bits; ``planes`` (b_li, b_val, gene_block, n_gb) stand for the
    bench operand where given. Returns one dict a shape, each printed as a
    JSON line."""
    from singlet_tpu_torch.ops import bell_cuda
    from singlet_tpu_torch.ops.maskbits import pack_mask_words
    from singlet_tpu_torch.ops.rngmask import seed_pair

    card = card or card_line()
    lib = bell_cuda._mse_lib()
    warp = warp_kernel(old_src)
    stream = torch.cuda.current_stream().cuda_stream
    seed = seed_pair(MASK_SEED)
    operands = {} if planes is None else {"bench": planes}
    rows = []
    for label, which, c0, n, k, against in shapes:
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
        plan = bell_cuda.b7_wide_plan(n, n_gb, G, width, k)
        bm = torch.empty(n_gb * plan.n_ct * plan.cells * plan.bm_pitch,
                         dtype=torch.int32, device="cuda")
        if against == "tiled":
            tiled = bell_cuda.b7_plan(n, n_gb, G, width, k)
            tbm = torch.empty(n_gb * tiled.n_ct * tiled.cells
                              * tiled.bm_pitch, dtype=torch.int32,
                              device="cuda")
        head = (li.data_ptr(), lv.data_ptr(), li.stride(0), n_gb, width, n,
                G, words.data_ptr(), words.stride(0))
        outs = {name: torch.empty((2, n), device="cuda")
                for name in ("old", "new")}

        def call(name):
            out = outs[name]
            if name == "new":
                err = lib.bell_mse_bits_wide(
                    *head, Wd.data_ptr(), H.data_ptr(), k, plan.npl,
                    plan.cells, plan.rows, int(plan.h_shared), bm.data_ptr(),
                    plan.n_ct * plan.cells, plan.bm_pitch, out.data_ptr(),
                    stream)
            elif against == "warp":
                err = warp(*head, Wd.data_ptr(), H.data_ptr(), k,
                           out.data_ptr(), stream)
            else:
                wp = bell_cuda.b7_wd_operand(Wd, tiled.npl)   # as the
                err = lib.bell_mse_bits(                       # wrapper does
                    *head, wp.data_ptr(), H.data_ptr(), k, tiled.npl,
                    tiled.cpw, tiled.walkers, tiled.rows, tbm.data_ptr(),
                    tiled.n_ct * tiled.cells, tiled.bm_pitch,
                    out.data_ptr(), stream)
            if err:
                raise RuntimeError(f"B7 {name} {label} k={k}: {err}")

        for name in outs:
            outs[name].fill_(float("nan"))
            call(name)
        torch.cuda.synchronize()
        if not torch.equal(outs["old"], outs["new"]):
            bad = int((outs["old"] != outs["new"]).any(dim=0).sum())
            raise AssertionError(f"B7 wide {label} k={k}: {bad} cells "
                                 "differ")
        row = {"kernel": "B7-wide", "shape": label, "cells": n, "k": k,
               "width": width, "gene_block": G,
               "old": (Path(old_src or WIDE_OLD).name if against == "warp"
                       else "bell_mse_bits.cu, the tiled kernel"),
               "held_out": int(outs["new"][1].sum()),
               "plan": plan._asdict(), "card": card, "same_bits": True,
               **wide_turns(torch, call, 0.0)}
        print(json.dumps(row), flush=True)
        rows.append(row)
        del Wd, H, words, bm, outs
        torch.cuda.empty_cache()
    return rows


def main() -> int:
    import torch

    from singlet_tpu_torch import _build
    from singlet_tpu_torch.ops.bell_cuda import b7_plan, b7_wd_operand
    from singlet_tpu_torch.ops.maskbits import pack_mask_words
    from singlet_tpu_torch.ops.rngmask import seed_pair

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--wide", action="store_true",
                    help="B7's wide route against OLD's (default "
                         "csrc/bell_mse_bits_wide_warp.cu) and the tiles")
    ap.add_argument("old", type=Path, nargs="?")
    ap.add_argument("new", type=Path, nargs="?",
                    default=_build.CSRC_DIR / "bell_mse_bits.cu")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("ab_bell_mse needs a CUDA device")
    card = card_line()
    if args.wide:
        run_wide(torch, card=card, old_src=args.old)
        return 0
    if args.old is None:
        ap.error("OLD.cu is needed without --wide")
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

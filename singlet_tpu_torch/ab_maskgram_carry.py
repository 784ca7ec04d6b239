"""Time the bits route's mask products of an older source against the
current ones on one CUDA card, in turns, on the same inputs: the w-side
products B8 and B13 and the carry products B9 and B14.

    python3 -m singlet_tpu_torch.ab_maskgram_carry OLD_BITS.cu OLD_M8.cu

OLD_BITS.cu and OLD_M8.cu are earlier versions of ``csrc/maskgram_bits.cu``
and ``csrc/maskgram_m8.cu`` with the single-kernel design (``mma.sync``, P
staged through registers, P contiguous). Each kernel that they export is
compared: ``mask_packed_w_t_bits`` (B8) and ``mask_packed_w_t_m8`` (B13)
as PR 9's sources export them, ``mask_packed_h_t_bits`` (B9) and
``mask_packed_h_t_m8`` (B14) as PR 8's did. They are compiled with
``_build``'s nvcc flags, started together, into the git-ignored
``build/``; the current kernels are those of ``ops/maskgram_cuda.py``
(``csrc/maskgram_gemm.cu``).

The inputs are those of ``chip_smoke.py``'s B8/B9/B13/B14 rows: the
524,288 x 16,384 operand's 8192-cell slice at cell 262,144 (its test mask,
seed 1, inv_density 20, packed into bitplane words and unpacked into the
int8 mask on the card), k=100 (5050 pairs). B8/B13 take its first 2048-cell
block and the packed products of random factors W (genes x k), B9/B14 all
of it in 4 quantization groups of 2048 cells, each group's packed
products of random factors H quantized on its own; int8 quantized or
bf16. Each version gets P in the layout it reads: the old contiguous, the
new as the engine hands it over (int8 K-major, bf16 pair-padded). Per
dtype and kernel, each turn times one version as the median of ``RUNS``
calls by CUDA events (B9/B14 update the carry in place in one reused
buffer), in the order old, new, new, old repeated ``ROUNDS`` times; the
new kernel's pass alone is timed beside it. int8 outputs must be equal bit
for bit, bf16 within 1e-5 x max |output|. Prints one JSON line per (dtype,
kernel) with every turn's time and the card's name and power limit; then
one line with int8 B8 on the first 1536, 1792 and 2048 cells of the block
(6, 7 and 8 tiles of 256 cells by 40 pair tiles: 240, 280 and 320 CTAs,
1.82, 2.12 and 2.42 waves of 132), which shows what the partial last wave
costs.
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

GENES, GENE_BLOCK, CELLS, GROUP, K = 16384, 512, 8192, 2048, 100
CELL_OFFSET, MASK_SEED, INV_DENSITY = 262144, 1, 20
RUNS = 10
ROUNDS = 3
WAVE_CELLS = (1536, 1792, 2048)


def _bind(libs):
    """The old kernels each library exports, by name, with their argument
    types."""
    vp, ci = ctypes.c_void_p, ctypes.c_int
    bits, m8 = libs
    argtypes = {
        (bits, "mask_packed_w_t_bits", "B8"): [vp, ci, ci, vp, vp, ci, ci,
                                               ci, ci, vp, vp],
        (bits, "mask_packed_h_t_bits", "B9"): [vp, ci, ci, vp, ci, vp, ci,
                                               ci, ci, ci, ci, ci, ci, vp,
                                               vp],
        (m8, "mask_packed_w_t_m8", "B13"): [vp, ci, ci, vp, vp, ci, ci, vp,
                                            vp],
        (m8, "mask_packed_h_t_m8", "B14"): [vp, ci, ci, vp, ci, vp, ci, ci,
                                            ci, ci, vp, vp]}
    found = {}
    for (lib, symbol, kernel), types in argtypes.items():
        if hasattr(lib, symbol):
            fn = getattr(lib, symbol)
            fn.argtypes = types
            fn.restype = ci
            found[kernel] = fn
    return found


def _median_turn(torch, fn):
    times = []
    for _ in range(RUNS):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def _turns(torch, old, new):
    """Per version the medians of its turns, old, new, new, old."""
    turns = {"old": [], "new": []}
    for _ in range(ROUNDS):
        for who in ("old", "new", "new", "old"):
            turns[who].append(_median_turn(torch, old if who == "old"
                                           else new))
    return turns


def _compare(dtype, kernel, got_old, got_new):
    err = float((got_old - got_new).abs().max())
    scale = float(got_old.abs().max())
    if dtype == "int8" and not bool((got_old == got_new).all()):
        raise AssertionError(f"{kernel} int8: the versions differ by {err}")
    if not err <= 1e-5 * scale:
        raise AssertionError(f"{kernel} {dtype}: the versions differ by "
                             f"{err} > 1e-5 x {scale}")
    return err


def main() -> int:
    import torch

    from singlet_tpu_torch.ops import maskgram, maskgram_cuda
    from singlet_tpu_torch.ops.linalg import (packed_outer_products,
                                              triu_pairs)
    from singlet_tpu_torch.ops.maskbits import pack_mask_words
    from singlet_tpu_torch.ops.rngmask import seed_pair

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("old_bits", type=Path)
    ap.add_argument("old_m8", type=Path)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("ab_maskgram_carry needs a CUDA device")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    with ThreadPoolExecutor(2) as pool:
        old_fns = _bind(list(pool.map(_compile, (args.old_bits,
                                                  args.old_m8))))
    stream = torch.cuda.current_stream().cuda_stream

    ids = torch.arange(CELL_OFFSET, CELL_OFFSET + CELLS, device="cuda")
    words = pack_mask_words(seed_pair(MASK_SEED), ids, genes_pad=GENES,
                            gene_block=GENE_BLOCK, inv_density=INV_DENSITY,
                            cells_true=CELL_OFFSET + CELLS,
                            genes_true=GENES)
    m8 = maskgram_cuda.unpack_mask_bits_cuda(words, gene_block=GENE_BLOCK,
                                             genes_pad=GENES)
    w_blk, m8_blk = words[:GROUP], m8[:GROUP]
    n_gb = GENES // GENE_BLOCK
    iu = triu_pairs(K)
    npairs = iu[0].shape[0]
    gen = torch.Generator(device="cuda").manual_seed(K + 1)
    W = torch.rand((GENES, K), generator=gen, device="cuda")
    H = torch.rand((CELLS, K), generator=gen, device="cuda")
    acc0 = torch.rand((npairs, GENES), generator=gen, device="cuda")
    bc = maskgram.b9_sub_block(CELLS, GROUP)
    Pw = packed_outer_products(W, iu)
    for dtype in ("int8", "bf16"):
        int8 = int(dtype == "int8")
        make = maskgram.kmajor_buffer if int8 else maskgram.pair_buffer
        if int8:
            q = [maskgram.quantize_pairs(packed_outer_products(
                H[c0:c0 + GROUP], iu)) for c0 in range(0, CELLS, GROUP)]
            old_Pw, Pw_s = maskgram.quantize_pairs(Pw, axis=0)
        else:
            ones = torch.ones(npairs, device="cuda")
            q = [(packed_outer_products(H[c0:c0 + GROUP], iu).bfloat16(),
                  ones) for c0 in range(0, CELLS, GROUP)]
            old_Pw, Pw_s = Pw.bfloat16(), ones
        old_Ph = torch.cat([x for x, _ in q])
        new_Ph = make(CELLS, npairs, "cuda")
        new_Ph.copy_(old_Ph)
        new_Pw = make(GENES, npairs, "cuda")
        new_Pw.copy_(old_Pw)
        scales = torch.stack([x for _, x in q], dim=1).contiguous()
        del q
        sptr = scales.data_ptr() if int8 else None
        wsptr = Pw_s.data_ptr() if int8 else None
        n_scales = CELLS // GROUP
        buf = acc0.clone()
        out = torch.empty((npairs, GROUP), device="cuda")

        def old(kernel, acc):
            fn = old_fns[kernel]
            if kernel == "B8":
                err = fn(old_Pw.data_ptr(), int8, npairs, wsptr,
                         w_blk.data_ptr(), GROUP, w_blk.shape[1],
                         GENE_BLOCK, n_gb, out.data_ptr(), stream)
            elif kernel == "B13":
                err = fn(old_Pw.data_ptr(), int8, npairs, wsptr,
                         m8_blk.data_ptr(), GROUP, GENES, out.data_ptr(),
                         stream)
            elif kernel == "B9":
                err = fn(old_Ph.data_ptr(), int8, npairs, sptr, n_scales,
                         words.data_ptr(), CELLS, words.shape[1],
                         GENE_BLOCK, n_gb, GENES, bc, GROUP,
                         acc.data_ptr(), stream)
            else:
                err = fn(old_Ph.data_ptr(), int8, npairs, sptr, n_scales,
                         m8.data_ptr(), CELLS, GENES, bc, GROUP,
                         acc.data_ptr(), stream)
            if err:
                raise RuntimeError(f"old {kernel} failed: {err}")
            return out if kernel in ("B8", "B13") else acc

        def new(kernel, acc):
            if kernel == "B8":
                return maskgram_cuda.mask_packed_w_t_bits_cuda(
                    new_Pw, Pw_s, w_blk, gene_block=GENE_BLOCK)
            if kernel == "B13":
                return maskgram_cuda.mask_packed_w_t_m8_cuda(
                    new_Pw, Pw_s, m8_blk, gene_block=GENE_BLOCK)
            if kernel == "B9":
                return maskgram_cuda.mask_packed_h_t_bits_cuda(
                    new_Ph, scales, words, acc, gene_block=GENE_BLOCK,
                    scale_block=GROUP)
            return maskgram_cuda.mask_packed_h_t_m8_cuda(
                new_Ph, scales, m8, acc, gene_block=GENE_BLOCK,
                scale_block=GROUP)

        passes = {"B8": lambda: maskgram_cuda.pack_words_g_cuda(
                      w_blk, gene_block=GENE_BLOCK, genes_pad=GENES),
                  "B9": lambda: maskgram_cuda.pack_words_k_cuda(
                      words, gene_block=GENE_BLOCK, genes_pad=GENES),
                  "B13": lambda: maskgram_cuda.pack_mask8_g_cuda(m8_blk),
                  "B14": lambda: maskgram_cuda.pack_mask8_k_cuda(m8)}
        for kernel in ("B8", "B13", "B9", "B14"):
            if kernel not in old_fns:
                continue
            got_old = old(kernel, acc0.clone()).clone()
            got_new = new(kernel, acc0.clone())
            torch.cuda.synchronize()
            err = _compare(dtype, kernel, got_old, got_new)
            del got_old, got_new
            turns = _turns(torch, lambda: old(kernel, buf),
                           lambda: new(kernel, buf))
            pass_ms = _median_turn(torch, passes[kernel])
            w_side = kernel in ("B8", "B13")
            print(json.dumps({
                "kernel": kernel, "dtype": dtype,
                "cells": GROUP if w_side else CELLS,
                "groups": 1 if w_side else CELLS // GROUP, "genes": GENES,
                "k": K, "card": card, "max_abs_diff": err,
                "same_bits": dtype == "int8",
                "old_ms": turns["old"], "new_ms": turns["new"],
                "old_median_ms": statistics.median(turns["old"]),
                "new_median_ms": statistics.median(turns["new"]),
                "new_pass_ms": pass_ms}), flush=True)
        if int8:
            waves = {cells: _median_turn(
                torch, lambda c=cells: maskgram_cuda.mask_packed_w_t_bits_cuda(
                    new_Pw, Pw_s, w_blk[:c], gene_block=GENE_BLOCK))
                for cells in WAVE_CELLS}
            print(json.dumps({
                "kernel": "B8", "dtype": dtype, "waves_cells": WAVE_CELLS,
                "ms": [waves[c] for c in WAVE_CELLS],
                "ctas": [-(-c // 256) * -(-npairs // 128) for c in WAVE_CELLS],
                "card": card}), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())

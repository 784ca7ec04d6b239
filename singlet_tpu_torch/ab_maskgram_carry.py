"""Time the bits route's carry products B9 and B14 of an older source
against the current ones on one CUDA card, in turns, on the same inputs.

    python3 -m singlet_tpu_torch.ab_maskgram_carry OLD_BITS.cu OLD_M8.cu

OLD_BITS.cu and OLD_M8.cu are earlier versions of ``csrc/maskgram_bits.cu``
and ``csrc/maskgram_m8.cu`` whose ``mask_packed_h_t_bits`` and
``mask_packed_h_t_m8`` take P (cells, np) contiguous with the signatures
of the single-kernel design (``mma.sync``, P staged through registers).
They are compiled with ``_build``'s nvcc flags, started together, into the
git-ignored ``build/``; the current kernels are those of
``ops/maskgram_cuda.py`` (``csrc/maskgram_gemm.cu``).

The inputs are those of ``chip_smoke.py``'s B9/B14 rows: the 524,288 x
16,384 operand's 8192-cell slice at cell 262,144 (its test mask, seed 1,
inv_density 20, packed into bitplane words and unpacked into the int8 mask
on the card), k=100 (5050 pairs), 4 quantization groups of 2048 cells,
each group's packed products of random factors quantized on its own
(int8) or rounded to bf16. Each version gets P in the layout it reads: the
old contiguous, the new as the engine hands it over (int8 K-major, bf16
pair-padded). Per dtype and kernel, each turn times one version as the
median of ``RUNS`` calls by CUDA events (the carry updated in place in one
reused buffer), in the order old, new, new, old repeated ``ROUNDS`` times;
the new kernel's pass alone is timed beside it. int8 outputs must be equal
bit for bit, bf16 within 1e-5 x max |output|. Prints one JSON line per
(dtype, kernel) with every turn's time and the card's name and power
limit.
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


def _bind(libs):
    vp, ci = ctypes.c_void_p, ctypes.c_int
    bits, m8 = libs
    bits.mask_packed_h_t_bits.argtypes = [vp, ci, ci, vp, ci, vp, ci, ci,
                                          ci, ci, ci, ci, ci, vp, vp]
    bits.mask_packed_h_t_bits.restype = ci
    m8.mask_packed_h_t_m8.argtypes = [vp, ci, ci, vp, ci, vp, ci, ci, ci,
                                      ci, vp, vp]
    m8.mask_packed_h_t_m8.restype = ci
    return bits.mask_packed_h_t_bits, m8.mask_packed_h_t_m8


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
        old_b9, old_b14 = _bind(list(pool.map(_compile, (args.old_bits,
                                                          args.old_m8))))
    stream = torch.cuda.current_stream().cuda_stream

    ids = torch.arange(CELL_OFFSET, CELL_OFFSET + CELLS, device="cuda")
    words = pack_mask_words(seed_pair(MASK_SEED), ids, genes_pad=GENES,
                            gene_block=GENE_BLOCK, inv_density=INV_DENSITY,
                            cells_true=CELL_OFFSET + CELLS,
                            genes_true=GENES)
    m8 = maskgram_cuda.unpack_mask_bits_cuda(words, gene_block=GENE_BLOCK,
                                             genes_pad=GENES)
    n_gb = GENES // GENE_BLOCK
    iu = triu_pairs(K)
    npairs = iu[0].shape[0]
    gen = torch.Generator(device="cuda").manual_seed(K + 1)
    H = torch.rand((CELLS, K), generator=gen, device="cuda")
    acc0 = torch.rand((npairs, GENES), generator=gen, device="cuda")
    bc = maskgram.b9_sub_block(CELLS, GROUP)
    for dtype in ("int8", "bf16"):
        if dtype == "int8":
            q = [maskgram.quantize_pairs(packed_outer_products(
                H[c0:c0 + GROUP], iu)) for c0 in range(0, CELLS, GROUP)]
            new_P = maskgram.kmajor_buffer(CELLS, npairs, "cuda")
        else:
            ones = torch.ones(npairs, device="cuda")
            q = [(packed_outer_products(H[c0:c0 + GROUP], iu).bfloat16(),
                  ones) for c0 in range(0, CELLS, GROUP)]
            new_P = maskgram.pair_buffer(CELLS, npairs, "cuda")
        old_P = torch.cat([x for x, _ in q])
        new_P.copy_(old_P)
        scales = torch.stack([x for _, x in q], dim=1).contiguous()
        del q
        int8 = int(dtype == "int8")
        sptr = scales.data_ptr() if int8 else None
        n_scales = CELLS // GROUP
        buf = acc0.clone()

        def old(kernel, acc):
            if kernel == "B9":
                err = old_b9(old_P.data_ptr(), int8, npairs, sptr, n_scales,
                             words.data_ptr(), CELLS, words.shape[1],
                             GENE_BLOCK, n_gb, GENES, bc, GROUP,
                             acc.data_ptr(), stream)
            else:
                err = old_b14(old_P.data_ptr(), int8, npairs, sptr, n_scales,
                              m8.data_ptr(), CELLS, GENES, bc, GROUP,
                              acc.data_ptr(), stream)
            if err:
                raise RuntimeError(f"old {kernel} failed: {err}")
            return acc

        def new(kernel, acc):
            if kernel == "B9":
                return maskgram_cuda.mask_packed_h_t_bits_cuda(
                    new_P, scales, words, acc, gene_block=GENE_BLOCK,
                    scale_block=GROUP)
            return maskgram_cuda.mask_packed_h_t_m8_cuda(
                new_P, scales, m8, acc, gene_block=GENE_BLOCK,
                scale_block=GROUP)

        passes = {"B9": lambda: maskgram_cuda.pack_words_k_cuda(
                      words, gene_block=GENE_BLOCK, genes_pad=GENES),
                  "B14": lambda: maskgram_cuda.pack_mask8_k_cuda(m8)}
        for kernel in ("B9", "B14"):
            got_old = old(kernel, acc0.clone())
            got_new = new(kernel, acc0.clone())
            torch.cuda.synchronize()
            err = float((got_old - got_new).abs().max())
            scale = float(got_old.abs().max())
            if dtype == "int8" and not torch.equal(got_old, got_new):
                raise AssertionError(f"{kernel} int8: the versions differ "
                                     f"by {err}")
            if not err <= 1e-5 * scale:
                raise AssertionError(f"{kernel} {dtype}: the versions "
                                     f"differ by {err} > 1e-5 x {scale}")
            del got_old, got_new
            turns = {"old": [], "new": []}
            for _ in range(ROUNDS):
                for who in ("old", "new", "new", "old"):
                    fn = old if who == "old" else new
                    turns[who].append(_median_turn(
                        torch, lambda: fn(kernel, buf)))
            pass_ms = _median_turn(torch, passes[kernel])
            print(json.dumps({
                "kernel": kernel, "dtype": dtype, "cells": CELLS,
                "groups": CELLS // GROUP, "genes": GENES, "k": K,
                "card": card, "max_abs_diff": err,
                "same_bits": dtype == "int8",
                "old_ms": turns["old"], "new_ms": turns["new"],
                "old_median_ms": statistics.median(turns["old"]),
                "new_median_ms": statistics.median(turns["new"]),
                "new_pass_ms": pass_ms}), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())

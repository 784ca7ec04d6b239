#!/usr/bin/env python3
"""Smoke run of ``singlet_tpu_torch`` on one CUDA card (written for an H100).

Run from the root of a checkout, with no arguments:

    python3 chip_smoke.py

Phases; any failure raises and the script exits non-zero:

0. device: torch and CUDA versions, the card's name and power limit;
1. build: compile every CUDA kernel from ``csrc/``, one nvcc per source,
   and the C++ IO library (``native/singlet_io.cpp``, g++), all started
   together;
2. kernel B1 (``ops/nnls_cuda.py``) against its plain PyTorch version on the
   card, at the half-update shapes of the bench config and at edge shapes,
   with both sweep caps the fit uses, and with a per-coordinate (n, k) L1
   at the fast cap; times both with CUDA events; then on Grams with a
   zero diagonal (a factor zero on every row) on both of its routes: the
   plain version's NaN columns, the rest within the gate;
3. kernel B2 likewise, on the solve inputs of real masked half-updates
   of the bench operand (h-side and w-side blocks at k=50 and 100, the
   large config's call shapes 2048 x 100 and 16384 x 100, an edge shape),
   at the masked fast cap 32 and at 100: its packed entry (a_full and the
   packed corrections, the fits' route) the same bits as its tile entry
   on the unpacked Grams; times of both entries, of the unpack alone and
   of the plain version; both entries with a per-coordinate (n, k) L1 at
   three of those shapes, and on masked Grams with a zero diagonal (a
   factor held out on every one of its rows) in three layouts, against
   the plain version (its NaN columns);
3b. the bits route's pair operands (``quantized_pairs_cuda``,
   ``csrc/quantized_pairs.cu``) at the 524k atlas's shapes, a 2048-cell
   block and the w-side's 16,384 genes at k=100: int8 and bf16 the same
   bits as the eager chain they replaced (``quantized_pairs_plain`` on the
   card), in the engine's layouts; the kernel's device time (CUDA events
   over 50 launches queued behind a wait, so the host's work is not in
   it), its bound and the chain's time;
4. ``run_nmf`` on the card against ``run_nmf`` on the CPU at a small size;
5. the masked fit ``ard_nmf_fit`` on the card against the CPU at the same
   small size;
6. the plain fit at the bench scale (16384 genes x 8192 cells, k=50, 7%
   dense): ``run_nmf`` from the numpy operand for 2 iterations, then
   ``nmf_fit`` on the uploaded providers for 10 iterations and for a race
   to tol=1e-5 (timed without the upload, and with the tol trace); checks
   that every half-update went through kernel B1 and none through the
   plain version; then the race once more under torch.profiler, for device
   time by kernel and the device's idle share;
7. the masked rank search at the bench scale: the test mask's build time
   and size, ``ard_nmf_fit`` at k=50 for 10 iterations (ms per masked
   iteration, the test-MSE trace, 8 B2 launches per iteration, no B1 and
   no plain call), once more under torch.profiler, then
   ``cross_validate_nmf`` at ranks 5, 10 and 20;
8. the user's entry point ``ard_nmf`` on a planted-rank operand of the
   bench shape: it must select the planted rank within 2;
9. kernels B3 and B4 (``ops/bell_cuda.py``) against their plain versions
   on the card, plain and masked (inv_density 20), on the ELL planes of the
   bench operand given as scipy (k=50) and on a slice of 4 cell blocks of
   the large operand (k=100): max abs error within 1e-5 x max |output|,
   the same bits on a second run, an exact 0/1 case; then kernels B5-B9
   and B12-B14 (``ops/bell_cuda.py``, ``ops/maskgram_cuda.py``) on the
   same planes with their packed test mask: B5 and B6 the same bits as
   masked B3 and B4, B7's sums within rtol 2e-4 and its counts equal, B12
   the same bytes as its plain version, B8 and B13 (one block) and B9 and
   B14 (4 quantization groups), P as the engine hands it over and
   contiguous, on int8 the same bits as their plain versions (and B13/B14
   as B8/B9; B13 also on bf16), twice, and on bf16 within 1e-5 x max
   |output|; the passes of B8/B13 and B9/B14 (``csrc/maskgram_gemm.cu``:
   the mask packed along the genes or the cells for the shared GEMM) the
   words of their plain versions and of B10's or B11's hash pass; and
   once more on an edge geometry (40 gene blocks, 3 groups of 1000
   cells). Times of kernel (with its pass, and the pass alone), plain
   version and library call (torch.sparse.mm on a CSR copy for B3-B6,
   torch._int_mm on the unpacked int8 mask for B8/B9 and B13/B14), and
   each kernel's bound (B8/B9/B13/B14 also the dense product at the
   peak); B3 (unmasked) and B5 also in turns with torch.sparse.mm
   (kernel, library, library, kernel, 3 times), for the spread of the
   ratio;
10. the ELL engine against the dense providers on the bench operand from
   one W0: 5 plain iterations and a 5-iteration masked ``ard_fit`` on the
   f32 route (equal ``iter`` lists), within the fit tolerance; then the
   engine's default masked route on the card, the bits route (int8 and
   bf16), against its f32 route: the same traced iterations, test-MSE
   traces within rtol 1e-3, and the launches of B2 and B5-B9 alone; and
   each once more under ``SINGLET_TPU_MASK8=1`` (the prebuilt int8 mask:
   B12-B14 in place of B8/B9), int8 bit for bit the bits route's fit,
   bf16 its test-MSE trace within 1e-5 relative;
10b. ranks above 224: B1, B2, B3, B4, B5, B6 and B7 at k=256 and 300
   against their plain versions (the bench planes for B3-B7; B6 the bits
   of masked B4; B2 both entries, the same bits); ``run_nmf`` at k=256
   on a 4096 x 2048 operand, and the ELL engine's plain fit and masked
   ``ard_fit`` at k=256 on a small operand, on the card against the CPU
   (B3 and B5 launch once a call at any k); then ranks above 512, the
   wide-k routes: B1, B2 (both entries, the same bits) and B7 at k=600
   against their plain versions (sweep cap 8), ``run_nmf`` at k=600 on a
   4096 x 2048 operand on the card against the CPU, and the ELL engine's
   bits-route ``ard_fit`` at k=600 against the dense masked fit on a
   1800 x 1800 planted block operand (the same traced iterations, the
   factors within the fit gate, test MSE within rtol 1e-3), each wide
   route's launches counted; B1 (2048 columns) and B2's packed entry (512)
   at k=600, cap 8, in turns with the warp-a-column kernel the staged
   kernel replaced (``csrc/nnls_wide_warp.cu``; the same bits); past k =
   2048, B1 (2048 columns) and B2 (512, both entries) at k=2560 on the
   staged kernels at 64 threads a column against their plain versions and
   in turns with the warp-a-column kernel they replaced there
   (``nnls_wide.cuh``'s own, forced); B7 (its tiles of cells) the bits of
   the warp-a-cell kernel it replaced (``csrc/bell_mse_bits_wide_warp.cu``)
   and in turns with it at k=600, and past the last k of Wd's rows in
   registers (Wd's rows streamed) at k=1100 and 2560, against its plain
   version, the same bits, in turns;
   then the wide routes at the bench config's size, k=600: the dense fit
   loop of ``run_nmf`` for 3 plain iterations (B1-wide's calls by CUDA
   events), one bits-route masked step of the ELL engine (its state
   reckoned first; B2-wide's h-side and w-side calls by CUDA events), one
   test MSE on its output (B7-wide's call by CUDA events), and the same
   calls' shapes in turns with the warp-a-column kernel, the first 512
   columns of each within the B1/B2 gate of the plain version;
10c. gene blocks past the tiles of B3 and B5: 16,384 genes in two gene
   blocks of 8,192 at 4,096 cells (824 requested nonzeros a cell): B3
   (plain and masked) and B5 on their wide-block route, and B7, against
   their plain versions, B5 the bits of masked B3; B3 and B5 at k = 50
   and 100 in 5 rounds of turns with the one-warp-per-cell kernel the
   route replaced (``csrc/bell_spmm_wide_warp.cu``, the same bits) and
   torch.sparse.mm (new, old, library, library, old, new; a sample the
   mean of 5 calls back to back); the route
   forced by the plan at a gene block of 512 the tiled kernel's bits;
   B7's wide route at k=600 on these planes (a cell's 416 slots of a gene
   block walked in passes) against its plain version and the bits of the
   warp-a-cell kernel it replaced, in turns with that kernel at k=600 and,
   forced, at k=50 and 100, where also in turns with the tiled kernel the
   plan takes there;
   the engine's plain fit and f32-route masked fit on these planes
   against the dense providers within the fit tolerance, and its
   bits-route fit against the f32 route's test MSE within rtol 1e-3;
11. the large operand of benchmarks/largescale.py generated on the card
   (524,288 cells x 16,384 genes, 824 nonzeros per cell, k=100): the plain
   ELL fit for 10 iterations at tol=0 (ms per iteration, cells/s, B1, B3
   and B4 launches, no plain call), ``project`` of all cells, one plain
   step under torch.profiler (with B3's, B1's and B4's shares of its
   device time, and B3's time by CUDA events inside the profiled call,
   since the profiler's list has missed it); the masked ``ard_fit`` on the
   f32 route for 1 traced iteration, with one f32 masked step and test MSE
   under the profiler; then the bits route: the test mask packed (seconds, GiB), the
   masked ``ard_fit`` for 2 traced iterations (per iteration exactly 256
   B5, B6, B8, 16 B9, 257 B2 and one B7 launch, nothing else), one step
   and one test MSE timed and under the profiler (with B2's, B5's, B6's,
   B8's and B9's shares of its device time, B8's and B9's passes apart,
   B2's h-side and w-side calls apart by launch grid; the test MSE with
   B7's time by CUDA events inside the profiled call); then the
   step under ``SINGLET_TPU_MASK8=1`` (per step 16 B12, 256 B13, 16 B14), timed
   in turns with the bits step (bits, MASK8, MASK8, bits; the same bits),
   the peak memory of each, B12 on one group's words the same bytes as its
   plain version, B14 on one group (16 quantization blocks of 2048 cells,
   int8, P as the engine hands it over) the same bits as its plain version
   and as B9, each timed (B9 and B14 with their passes apart), and one
   MASK8 step under the profiler (with B13's and B14's shares);
12. the user's entry points on the ELL route: the planted rank-10
   operand as scipy CSC (past 64e6 entries), ``ard_nmf`` (10 +- 2) and
   ``cross_validate_nmf`` at ranks 5, 10 and 20, their masked fits on the
   default bits route;
13. kernels B10 and B11 (``ops/maskgram_cuda.py`` on
   ``csrc/maskgram_gemm.cu``: the hash route's mask products, bf16, a
   hash pass that packs the mask along K, then the wgmma GEMM fed by TMA
   that B9 and B14 share), run beside phases 9 and 11: on the bench operand (k=50), on an
   edge geometry (1280 genes in gene blocks of 32, 3000 cells from cell
   12345 in blocks of 1000, true sizes 2990 cells and 1270 genes) and on
   the 8192-cell slice of the large operand (k=100; B10 on its first
   2048-cell block, B11 over it block by block), P handed over as the
   engine does (views of buffers with the pair axis padded to 64): the
   hash pass alone the plain version's words bit for bit, each kernel
   within 1e-5 x max |output| of its plain version, the same bits twice,
   and within 1e-5 x max |output| of bf16 B8/B9 on the packed words of
   the same cells; per call the times of kernel, hash pass, plain version
   and library call (torch.matmul of the bf16 mask) and the bound; and,
   in turns (old, new, new, old), bf16 B8/B9 on the packed words against
   B10/B11 on the same cells and P (bf16 B8 runs B10's GEMM, bf16 B9
   B11's, each after its own pass);
14. resumable fits (``checkpoint=``), each stopped and resumed and equal
   bit for bit to the uninterrupted run: after phase 7, ``nmf_fit`` and
   ``ard_nmf_fit`` at the bench config (checkpoints every 5, stopped at
   10, resumed to 20; also equal to the uncheckpointed fit); after phase
   10, the ELL engine's checkpointed ``ard_fit`` on the bench operand on
   the card's default mode, which takes the hash route (stopped at 2,
   resumed to 5), its test-MSE trace within rtol 1e-3 of the bits route's,
   and under ``SINGLET_TPU_MASK8=1`` a checkpointed fit that still takes
   the hash route, bit for bit the one without;
   after phase 8, ``ard_nmf``'s search-state checkpoint (stopped by
   ``max_fits=3``, resumed: the same rank, cv_data and model); at the end
   of phase 11, the checkpointed masked ``ard_fit`` at 524,288 x 16,384,
   k=100 on the hash route (1 iteration, resumed to 2, per step a B3, B4,
   B10 and B11 per block), then one hash-route step, one hashed test MSE
   (each timed and under the profiler) and one checkpoint save timed. The
   checkpoints go to a temporary directory under the git-ignored
   ``build/``, removed at the end;
15. streaming ingest on 131,072 cells x 16,384 genes (824 requested
   nonzeros per cell, about 105M stored), made on the host as 16 scipy
   chunks of 8192 cells: the C++ IO library (``native/singlet_io.cpp``)
   built and loaded (the phase fails if it is not); its ``csc_to_bell`` and
   the numpy packer on the concatenated matrix, the same planes, both
   timed (host s) with the planes' GiB; the chunk list ingested
   (``shard_ell_from_chunks``) into planes equal on the card, bit for bit,
   to ``shard_ell_data`` of the concatenation; ``stage_chunks`` into a
   directory under ``build/`` in the v1 and the v2 (value-grouped) shard
   encoding, bytes on disk and seconds, each staged directory ingested
   (``shard_ell_from_staged``) into the same planes; ``run_nmf`` on the
   v2 directory (k=100, tol=0, maxit=3, one W0) bit for bit the same fit
   from the concatenated matrix's engine, B1, B3 and B4 alone; and
   ``cross_validate_nmf`` on the v1 directory at one rank for 2 iterations
   on the default bits route (B2, B5-B9); the directory removed at the end;
   then (15b) the v2 directory ingested at gene block 8,192, where B3 and
   B5 take their wide-block route, beside the monolithic engine at 512:
   per gene block 3 plain iterations from W0 (ms each, B3 by CUDA events
   inside them) and one bits-route masked step (B5 by CUDA events inside
   it), the two plain fits within the fit tolerance of each other;
16. the remaining solvers: each entry point on the card against the same
   call on the CPU at a small size (``run_linked_nmf``, ``project_model``,
   ``nmf_batch`` dense and ``batch_fit``, ``gcnmf`` dense and
   ``gcnmf_fit``, ``mu_nmf`` both steps from one init, ``local_knn`` for
   five metrics on exact integer distances, ``snn_graph``,
   ``spatial_graph``); at the bench config from one W0, the engine side
   against the dense side within the fit tolerance, with equal iteration
   counts and tol traces within it (linked NMF,
   projection, ``batch_fit`` against ``nmf_batch`` with 4 batches,
   ``gcnmf_fit`` against ``gcnmf`` with G from ``local_knn`` on synthetic
   coordinates, 10 neighbours), each timed; on phase 15's engine,
   ``batch_fit`` and ``gcnmf_fit`` at k=100 for 3 iterations (ms per
   iteration), G's plane width and GiB, and B3 on G's planes and on A's
   planes timed apart by CUDA events. Every counted run launches B1, B3
   and B4 alone and no plain version;
17. the cell mesh on the card, on phase 15's operand (the staged
   directories are kept until this phase) and the bench config: (a) a
   world of one over NCCL in this process (``make_mesh()``): ``run_nmf``
   on the v2 directory with ``mesh=`` (3 iterations) bit for bit phase
   15's fit, then on phase 15's planes on the mesh the plain fit (3), the
   bits-route ``ard_fit`` (2), ``gcnmf_fit`` with phase 16's G (2), and
   the dense mesh engine ``sharded_nmf_fit`` plain (3) and masked (2) at
   the bench config, each bit for bit the same fit with no mesh, with the
   kernels' launches checked, ms per step against no mesh and the
   collectives' bytes and ms; the process group destroyed; (b) two
   processes sharing the card over gloo (``--mesh-worker``, cuda:0, the
   kernels loaded from phase 1's build), each reading only its shards of
   the v1 directory (``shard_ell_from_staged``), the same five fits, each
   within rtol 5e-3, atol 5e-4 of (a), with equal iteration counts and
   equal W bits on both ranks; their ms per step (two processes on one
   card: not a scaling figure), collective bytes and ms, and which
   collectives gloo takes on CUDA tensors;
18. the pipeline, last: a 10x directory of 16,384 genes x 8,192 cells
   (824 requested nonzeros a cell, raw counts 1 + Poisson(0.6)) written
   under ``build/``; ``cellxgene_pipeline`` on it with k=10 and with
   k=[5, 10, 15], each stage timed (read, normalize, NMF, annotate,
   save), each model bit for bit the direct ``Experiment`` fit from the
   same seed, B1 (and B2 for the list) launched, the model files written;
   then ``annotate_nmf`` and ``run_gsea`` on the k=10 model.

Each counted run sets every launch counter to 0 just before it and reads
them just after. After the phases come the run's total seconds and three
lines: ``results: {...}`` with every number measured, ``{"kernels": [...]}`` and the card's name and power
limit; the last line is ``{"ok": true, "device": {...}}``. Without a CUDA
device the script exits 2 and prints no result.
"""

from __future__ import annotations

import contextlib
import json
import os
import shutil
import statistics
import subprocess
import sys
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
T_START = time.perf_counter()

# tolerance of the kernel against its plain version (tests/test_pallas_nnls.py
# uses the same): the sweep-end tol is summed in another order, so a
# borderline column may run one sweep more or fewer (moves of ~1e-8 relative)
KERNEL_RTOL, KERNEL_ATOL = 5e-3, 1e-6
# tolerance of the fit on the card against the fit on the CPU
# (tests/test_als.py uses the same against the float64 oracle)
FIT_RTOL, FIT_ATOL = 5e-3, 5e-4

KERNEL_SHAPES = [(8192, 50), (16384, 50), (1500, 10), (4096, 100)]
SWEEP_CAPS = [8, 100]
# kernel B1 with an (n, k) L1 at each of those shapes, at this cap
B1_L1_CAP = 8
# kernel B2 (n, k, side): the h-side block (2048 cells) and w-side block
# (4096 genes) of the bench config, the large config's two call shapes at
# k=100 (a 2048-cell block; all 16,384 genes), and a width that is no
# multiple of 32
B2_SHAPES = [(2048, 50, "h"), (4096, 50, "w"), (4096, 100, "w"),
             (2048, 100, "h"), (16384, 100, "w"), (1500, 10, "h")]
B2_SWEEP_CAPS = [32, 100]
# kernel B2 with a per-coordinate (n, k) L1 (batch mode) at these shapes of
# B2_SHAPES, at the masked fast cap
B2_L1_SHAPES = [(4096, 50, "w"), (2048, 100, "h"), (1500, 10, "h")]
# a zero Gram diagonal (n, k, coordinate): B1 on its shared-memory and
# device-memory routes, B2 on its shared-memory and streamed layouts
ZERO_DIAG_B1 = [(16384, 50, 17), (4096, 100, 0), (2048, 300, 299)]
ZERO_DIAG_B2 = [(4096, 50, 17), (2048, 100, 99), (512, 300, 0)]
# (n, k, cap) whose times the kernels line reports: the w-side
# half-update of the bench config in the fast phase, for each kernel
B1_REPORTED = (16384, 50, 8)
B2_REPORTED = (4096, 50, 32)
BENCH = dict(genes=16384, cells=8192, k=50, density=0.07, seed=42)
# the masked path: 5% test set (inv_density 20), one mask seed shared by
# the fits of phase 7 (cross_validate_nmf's replicate 1 uses seed 0 + 1)
MASKED = dict(k=50, inv_density=20, mask_seed=1, maxit=10)
CV_RANKS = [5, 10, 20]
PLANTED = dict(rank=10, seed=7, k_max=20)
SOURCES = ("nnls_cd", "nnls_cd_batched", "nnls_wide", "bell_spmm",
           "bell_mse_bits", "maskgram_m8", "maskgram_gemm",
           "bell_spmm_wide_warp", "bell_mse_bits_wide_warp",
           "quantized_pairs")
# the bits route's pair operands at the 524k atlas's k = 100: a 2048-cell
# block's H and the w-side's 16,384 genes of W
PAIRS_SHAPES = ((2048, 100, "h-side block"), (16384, 100, "w-side"))
# the H100 SXM's published peaks (NVIDIA's H100 datasheet), for the
# kernels' bounds: device memory, float32 outside the tensor cores, and the
# dense int8 and bf16 tensor-core rates
HBM_BYTES_S = 3.35e12
F32_OPS_S = 67e12
INT8_OPS_S = 1979e12
BF16_OPS_S = 989e12
# the profiled device time of B8, B9, B13 and B14 (each its pass and the
# int8 GEMM: carry-free for B8/B13, with the carry for B9/B14) in the
# large masked steps, by kernel name
B8_SHARES = ((("gpack_words", "mask_gemm_s8_kernel<false>"), "B8"),
             ("gpack_words", "B8_pass"))
B9_SHARES = ((("kpack_words_kernel", "mask_gemm_s8_kernel<true>"), "B9"),
             ("kpack_words_kernel", "B9_pass"))
B13_SHARES = ((("gpack_m8_kernel", "mask_gemm_s8_kernel<false>"), "B13"),
              ("gpack_m8_kernel", "B13_pass"))
B14_SHARES = ((("kpack_m8_kernel", "mask_gemm_s8_kernel<true>"), "B14"),
              ("kpack_m8_kernel", "B14_pass"))
# kernel B2's device time in the profiled steps: one kernel name for both
# entries, split into the h-side (2048-cell blocks) and w-side (all genes)
# calls by their launch grids
B2_SHARE = ("nnls_cd_col_kernel", "B2")
# kernels B3 and B4 against their plain versions: only the order of the
# sums differs
BELL_TOL = 1e-5
# benchmarks/largescale.py: cells x genes, nonzeros per cell, k; width 32
LARGE = dict(genes=16384, cells=524288, nnz=824, k=100, maxit=10,
             masked_maxit=2, masked_maxit_f32=1, gene_block=512,
             cell_block=2048)
# the large operand's slice for the kernel checks: 4 cell blocks of 2048
# at full gene width, at a cell offset inside the operand
LARGE_SLICE = (262144, 4 * 2048)
# ranks above 224: the kernels' ranks, run_nmf's operand, and a small
# operand for the ELL engine (three cell blocks, three gene blocks)
WIDE_K = (256, 300)
WIDE_RUN_NMF = dict(genes=4096, cells=2048, k=256, maxit=3)
WIDE_ELL = dict(genes=768, cells=768, k=256, maxit=2, cell_block=256,
                gene_block=256)
# ranks above 512, the wide-k routes of B1, B2 and B7: the kernels at k=600
# and sweep cap 8 (so that the plain versions stay short); run_nmf at k=600
# on a planted 4096 x 2048 block operand (a well-posed rank-600 fit); the
# ELL engine's bits-route ard_fit against the
# dense masked fit on an operand of 3 genes and 3 cells a factor, as
# WIDE_ELL's at k=256 (WIDE_ELL's own 768 x 768 would leave 1.3 a factor)
WIDE600 = dict(k=600, sweep_cap=8, b1_n=2048, b2_n=512)
WIDE600_RUN_NMF = dict(genes=4096, cells=2048, maxit=2)
WIDE600_ELL = dict(genes=1800, cells=1800, maxit=1, cell_block=256,
                   gene_block=256)
# the wide routes at the bench config's size (16,384 genes x 8,192 cells)
# and k = 600: run_nmf's dense fit loop for 3 plain iterations (B1-wide at
# n = 8,192 and 16,384), one bits-route masked step of the ELL engine
# (B2-wide on each 2,048-cell block and once over all genes), both from W
# and H drawn U(0, 1) with numpy; then the same calls' shapes in turns
# with the warp-a-column kernel (ab_nnls, ab_nnls_batched), each output's
# first 512 columns within the B1/B2 gate of the plain version
WIDE600_BENCH = dict(k=600, maxit=3, seed=600, plain_cols=512,
                     b1_turns=((8192, 600), (16384, 600)),
                     b2_turns=((2048, 600), (16384, 600)))
# past the last k of B7's Wd rows in registers (ops/bell_cuda.py
# MAX_K_MSE_WIDE): the wide route's streamed form on the bench planes at
# B7_PAST_K and 2560, each against its plain version, the bits of the
# warp-a-cell kernel it replaced and in turns with it; past the staged
# kernels' last k at 32 threads a column (2048): B1 (2048 columns) and B2
# (512, both entries) at k = 2560, sweep cap 8, against their plain
# versions and in turns with the warp-a-column kernel they replaced
B7_PAST_K = 1100
WIDE_PAST = dict(k=2560, b7_ks=(B7_PAST_K, 2560))
WIDE_TURN_NOTE = ("old, new, new, old: 5 rounds, a turn the median of 3 "
                  "single calls by CUDA events (of one call where the old "
                  "one takes over 0.1 s)")
# gene blocks past the tiles of B3 (7,168 genes) and B5 (5,632): the large
# config's 16,384 genes and 824 requested nonzeros a cell in two gene
# blocks of 8,192, at 4,096 cells; the plain versions of B3 and B5 by
# slices of 256 cells (one gene block's one-hot tile of all the cells would
# not fit on the card)
WIDE_BLOCK = dict(genes=16384, cells=4096, nnz=824, gene_block=8192,
                  cell_block=2048, k=50, maxit=3, masked_maxit=2,
                  plain_cells=256, turn_ks=(50, 100), rounds=5,
                  tiled_block=512, b7_k=600)
# phase 15's operand on the engine at the wide-block route's gene block and
# at the default 512 (B3/B5's tiles), k=100: plain iterations and one
# bits-route masked step each
WIDE_STREAM = dict(gene_blocks=(8192, 512), maxit=3)
# the last phase, the pipeline on a 10x directory at the large config's
# width: 16,384 genes x 8,192 cells, 824 requested nonzeros a cell
PIPELINE = dict(genes=16384, cells=8192, nnz=824, seed=19, k=10,
                ks=(5, 10, 15), groups=4)
# phase 15, streaming ingest: the large config's genes and requested
# nonzeros per cell (824, drawn with replacement, so about 804 stored) at a
# quarter of its cells, made on the host as chunks of 8192 cells, raw
# counts 1 + Poisson(0.6); the fits at k=100 for 3 iterations, the CV at
# one rank for 2
STREAM = dict(genes=16384, cells=131072, nnz=824, chunk=8192, seed=15,
              k=100, maxit=3, cv_rank=100, cv_maxit=2)
# phase 16, the remaining solvers: the card against the CPU at a small
# size; the engine against the dense side at the bench config (10
# iterations at tol=0, 4 batches, G from local_knn: 10 neighbours within
# radius 2 of points spread 30 to that disc, 10 features); batch_fit and
# gcnmf_fit on phase 15's operand (k=100, 3 iterations)
SOLVERS = dict(maxit=10, batches=4, knn=10, radius=2.0, per_disc=30,
               features=10, seed=16, large_maxit=3)


_M32 = 0xFFFFFFFF


def _mul32(h, m: int):
    """(h * m) mod 2^32 for int64 h in [0, 2^32) and a constant m < 2^32,
    without int64 overflow: m is split into 16-bit halves."""
    lo, hi = m & 0xFFFF, m >> 16
    return (h * lo + (((h * hi) & 0xFFFF) << 16)) & _M32


def _hash_val_torch(c, g):
    """benchmarks/largescale.py ``_hash_val`` on int64 tensors: a value in
    [0.1, 1.1) from (cell, gene)."""
    h = (_mul32(c, 2654435761) + _mul32(g, 40503) + 0x9E37) & _M32
    h = h ^ (h >> 16)
    h = _mul32(h, 2246822519)
    return (h >> 16).float() / 65536.0 + float(np.float32(0.1))


def synth_bell_planes_torch(genes: int, cells: int, nnz_per_cell: int,
                            gene_block: int = 512, device="cuda",
                            chunk: int = 32768):
    """The closed-form operand of benchmarks/largescale.py
    ``synth_bell_planes``, generated with torch on ``device`` in chunks of
    cells: (b_li int32, b_val float32) planes (n_gb * width, cells) and the
    width. Per gene block each cell holds ``nnz_per_cell // n_gb``
    jittered, evenly spaced genes with hashed values. Bit for bit the numpy
    planes (tests/test_torch_bell.py)."""
    import torch

    n_gb = genes // gene_block
    per_gb = max(1, nnz_per_cell // n_gb)
    width = ((per_gb + 7) // 8) * 8
    gb = torch.arange(n_gb, device=device)[:, None, None]
    w = torch.arange(width, device=device)[None, :, None]
    live = w < per_gb
    ws = torch.clamp(w, max=per_gb - 1)
    base = (ws * gene_block) // per_gb
    gap = torch.clamp(((ws + 1) * gene_block) // per_gb - base, min=1)
    mix = _mul32(gb * 131 + ws, 40503)
    b_li = torch.empty((n_gb * width, cells), dtype=torch.int32,
                       device=device)
    b_val = torch.empty((n_gb * width, cells), dtype=torch.float32,
                        device=device)
    for c0 in range(0, cells, chunk):
        c = torch.arange(c0, min(c0 + chunk, cells),
                         device=device)[None, None, :]
        h = ((_mul32(c, 2654435761) + mix) & _M32) & 0x7FFFFFFF
        li = torch.where(live, base + h % gap, -1)
        val = torch.where(live, _hash_val_torch(
            c, gb * gene_block + torch.clamp(li, min=0)), 0.0)
        b_li[:, c0:c0 + c.shape[2]] = li.reshape(n_gb * width, -1)
        b_val[:, c0:c0 + c.shape[2]] = val.reshape(n_gb * width, -1)
    return b_li, b_val, width


def _card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def _median_ms(torch, fn, runs: int, reps: int = 1) -> float:
    """Median over ``runs`` of one call's device time (CUDA events): with
    ``reps`` > 1 a sample is the mean of that many calls launched back to
    back, so that a call's host work overlaps the one before on the card,
    as in a fit."""
    times = []
    for _ in range(runs):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end) / reps)
    return statistics.median(times)


def _device_ms(torch, fn, calls: int = 50, runs: int = 5) -> float:
    """Median over ``runs`` of one call's device time: ``calls`` calls
    queued behind a wait on the card (``torch.cuda._sleep``), so that the
    CUDA events bracket the kernels back to back and none of the host's
    work between them."""
    times = []
    for _ in range(runs):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(20_000_000)
        start.record()
        for _ in range(calls):
            fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end) / calls)
    return statistics.median(times)


COUNTS = ("B1", "B2", "B3", "B4", "B5", "B6", "B7", "B8", "B9", "B10",
          "B11", "B12", "B13", "B14", "plain", "plain_bell", "plain_maskgram",
          "plain_maskbits", "B1w", "B2w", "B3w", "B5w", "B7w", "pairs")


def _launches(**nonzero):
    """A full launch-count dict: the given counts, every other one 0."""
    assert set(nonzero) <= set(COUNTS), nonzero
    return {key: nonzero.get(key, 0) for key in COUNTS}


def _counted(torch, fn):
    """Run ``fn`` with every launch counter set to 0 just before it; return
    (its result, wall seconds, the counts of COUNTS read just after: kernel
    launches of B1-B14, calls of the plain versions, and the launches of
    B1-B14 that took a wide route: B1w, B2w and B7w past k = 512, B3w and
    B5w on gene blocks past their tiles, each counted in B1-B7 too, and of
    the bits route's pair operands, ``pairs``)."""
    from singlet_tpu_torch.ops import (bell, bell_cuda, maskbits, maskgram,
                                       maskgram_cuda, nnls, nnls_cuda)

    counters = ((nnls_cuda, "LAUNCHES"), (nnls_cuda, "LAUNCHES_BATCHED"),
                (bell_cuda, "LAUNCHES_SPMM"), (bell_cuda, "LAUNCHES_SPMM_T"),
                (bell_cuda, "LAUNCHES_SPMM_BITS"),
                (bell_cuda, "LAUNCHES_SPMM_T_BITS"),
                (bell_cuda, "LAUNCHES_MSE_BITS"),
                (maskgram_cuda, "LAUNCHES_MPW_BITS"),
                (maskgram_cuda, "LAUNCHES_MPH_BITS"),
                (maskgram_cuda, "LAUNCHES_MPW_HASH"),
                (maskgram_cuda, "LAUNCHES_MPH_HASH"),
                (maskgram_cuda, "LAUNCHES_UNPACK8"),
                (maskgram_cuda, "LAUNCHES_MPW_M8"),
                (maskgram_cuda, "LAUNCHES_MPH_M8"),
                (nnls, "PLAIN_CALLS"), (bell, "PLAIN_CALLS"),
                (maskgram, "PLAIN_CALLS"), (maskbits, "PLAIN_CALLS"),
                (nnls_cuda, "LAUNCHES_WIDE"),
                (nnls_cuda, "LAUNCHES_BATCHED_WIDE"),
                (bell_cuda, "LAUNCHES_SPMM_WIDE"),
                (bell_cuda, "LAUNCHES_SPMM_BITS_WIDE"),
                (bell_cuda, "LAUNCHES_MSE_BITS_WIDE"),
                (maskgram_cuda, "LAUNCHES_PAIRS"))
    for mod, attr in counters:
        setattr(mod, attr, 0)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    return out, secs, {key: getattr(mod, attr)
                       for key, (mod, attr) in zip(COUNTS, counters)}


@contextlib.contextmanager
def _env(**values):
    """Environment variables set for the block (the fits read them when
    they are built), restored after it."""
    old = {key: os.environ.get(key) for key in values}
    os.environ.update(values)
    try:
        yield
    finally:
        for key, value in old.items():
            if value is None:
                os.environ.pop(key, None)
            else:
                os.environ[key] = value


def _nnls_problem(torch, n, k, seed):
    """Gram F^T F of random F, B = G F, a warm X0 with zeros, 5% of the
    columns masked out: the geometry of tests/test_pallas_nnls.py."""
    rng = np.random.default_rng(seed)
    m = max(64, 2 * k)
    F = rng.random((m, k)).astype(np.float32)
    a = (F.T @ F + 1e-15 * np.eye(k)).astype(np.float32)
    B = (rng.random((n, m), dtype=np.float32) @ F).astype(np.float32)
    X0 = (rng.random((n, k)) * (rng.random((n, k)) < 0.5)).astype(np.float32)
    mask = rng.random(n) >= 0.05
    dev = torch.device("cuda")
    return (torch.as_tensor(a, device=dev), torch.as_tensor(B, device=dev),
            torch.as_tensor(X0, device=dev), torch.as_tensor(mask, device=dev))


def _nnls_bound(sweeps, n, k, gram_floats):
    """Bound of a CD-NNLS call: the Gram(s), B, X0 and the mask read and X
    written once; per column sweep and coordinate the step (about 8 float32
    operations) and the residual downdate (2k), for the sweeps each column
    ran (the plain version counts them on the same inputs)."""
    ops = int(sweeps.sum()) * k * (2 * k + 8)
    return _bound(4 * (gram_floats + 3 * n * k) + n, ops, F32_OPS_S)


def phase_kernel(torch, card):
    from singlet_tpu_torch.ops import nnls
    from singlet_tpu_torch.ops.nnls_cuda import nnls_batch_cuda

    rows = []
    for n, k in KERNEL_SHAPES:
        a, B, X0, mask = _nnls_problem(torch, n, k, seed=n + k)
        # a per-coordinate (n, k) L1, the plain version's batch-mode branch
        L1s = {False: 0.01, True: 0.005 + 0.01 * torch.rand(
            (n, k), generator=torch.Generator(device="cuda").manual_seed(k),
            device="cuda")}
        for cap, l1_array in [(c, False) for c in SWEEP_CAPS] + [
                (B1_L1_CAP, True)]:
            kw = dict(L1=L1s[l1_array], L2=0.001, update_mask=mask,
                      sweep_cap=float(cap))
            Xk = nnls_batch_cuda(a, B, X0, **kw)
            Xp, sweeps = nnls.nnls_batch(a, B, X0, return_sweeps=True, **kw)
            torch.cuda.synchronize()
            np.testing.assert_allclose(Xk.cpu().numpy(), Xp.cpu().numpy(),
                                       rtol=KERNEL_RTOL, atol=KERNEL_ATOL)
            if not torch.equal(Xk[~mask], X0[~mask]):
                raise AssertionError(f"masked rows differ from X0 at "
                                     f"n={n} k={k} cap={cap}")
            err = float((Xk - Xp).abs().max())
            ms = _median_ms(torch, lambda: nnls_batch_cuda(a, B, X0, **kw),
                            runs=20)
            plain_ms = _median_ms(torch, lambda: nnls.nnls_batch(
                a, B, X0, **kw), runs=3)
            rows.append(dict(n=n, k=k, sweep_cap=cap, l1_array=l1_array,
                             max_abs_err=err, ms=ms, plain_ms=plain_ms,
                             library_ms=None,
                             **_nnls_bound(sweeps, n, k, k * k)))
            print(f"kernel B1 n={n} k={k} cap={cap}"
                  f"{' (n, k) L1' if l1_array else ''}: max|err|={err:.3e} "
                  f"kernel {ms:.4f} ms, plain {plain_ms:.3f} ms "
                  f"({card})", flush=True)
    # a zero Gram diagonal: the plain version's NaN columns
    for n, k, z in ZERO_DIAG_B1:
        a, B, X0, mask = _zero_diag_shared(torch, n, k, z, seed=n + z)
        kw = dict(L1=0.01, L2=0.001, update_mask=mask,
                  sweep_cap=float(B1_L1_CAP))
        _nan_gate(torch, f"B1 n={n} k={k} zero diagonal at {z}",
                  nnls_batch_cuda(a, B, X0, **kw),
                  nnls.nnls_batch(a, B, X0, **kw), mask, X0, card)
    return rows


def _zero_diag_shared(torch, n, k, z, seed):
    """``_nnls_problem``'s geometry with factor z zero on every row: the
    Gram's row, column and diagonal z exactly 0 and B's column z exactly
    0 (those columns turn NaN in the plain version), but b_z < 0 for a
    third of the columns (x_z clamps to 0, finite)."""
    rng = np.random.default_rng(seed)
    m = max(64, 2 * k)
    F = rng.random((m, k)).astype(np.float32)
    F[:, z] = 0.0
    eye = np.eye(k, dtype=np.float32)
    eye[z, z] = 0.0
    a = (F.T @ F + 1e-15 * eye).astype(np.float32)
    B = (rng.random((n, m), dtype=np.float32) @ F).astype(np.float32)
    B[::3, z] = -0.5
    X0 = (rng.random((n, k)) * (rng.random((n, k)) < 0.5)).astype(np.float32)
    mask = rng.random(n) >= 0.05
    return [torch.as_tensor(x, device="cuda") for x in (a, B, X0, mask)]


def _zero_diag_packed(torch, n, k, z, seed):
    """A masked half-update's solve inputs (a_full, packed_t, iu, B, X0,
    mask) where factor z is nonzero on one row alone, held out for the
    even columns: their Grams have row, column and diagonal z exactly 0
    and their b_z is exactly 0 (NaN in the plain version); the odd columns
    keep the row and stay finite."""
    from singlet_tpu_torch.ops import linalg

    rng = np.random.default_rng(seed)
    m = max(64, 2 * k)
    F = rng.random((m, k)).astype(np.float32)
    F[:, z] = 0.0
    F[3, z] = 0.75
    held = rng.random((n, m)) < 0.05
    held[:, 3] = np.arange(n) % 2 == 0
    Ft = torch.as_tensor(F, device="cuda")
    ht = torch.as_tensor(held, device="cuda")
    iu = linalg.triu_pairs(k)
    packed_t = linalg.mask_dot_t(linalg.packed_outer_products(Ft, iu), ht,
                                 1).contiguous()
    a_full = Ft.T @ Ft + 1e-15 * torch.eye(k, device="cuda")
    a_full[z, z] = float(np.float32(0.75) * np.float32(0.75))
    kept = torch.as_tensor(np.where(held, 0.0, rng.random((n, m))),
                           dtype=torch.float32, device="cuda")
    X0 = (rng.random((n, k)) * (rng.random((n, k)) < 0.5)).astype(np.float32)
    mask = rng.random(n) >= 0.05
    return (a_full.contiguous(), packed_t, iu, (kept @ Ft).contiguous(),
            torch.as_tensor(X0, device="cuda"),
            torch.as_tensor(mask, device="cuda"))


def _nan_gate(torch, label, got, want, mask, X0, card):
    """A kernel's result on a zero-diagonal problem: the plain version's NaN
    positions and, elsewhere, its values within KERNEL_RTOL/KERNEL_ATOL;
    held columns X0 bit for bit. Prints and returns the NaN columns'
    count."""
    torch.cuda.synchronize()
    np.testing.assert_allclose(got.cpu().numpy(), want.cpu().numpy(),
                               rtol=KERNEL_RTOL, atol=KERNEL_ATOL,
                               equal_nan=True, err_msg=label)
    if not torch.equal(got[~mask], X0[~mask]):
        raise AssertionError(f"{label}: held columns differ from X0")
    nan_cols = int(torch.isnan(want).any(dim=1).sum())
    if not 0 < nan_cols < want.shape[0]:
        raise AssertionError(f"{label}: {nan_cols} NaN columns of "
                             f"{want.shape[0]}")
    print(f"kernel {label}: the plain version's {nan_cols} NaN columns, the "
          f"rest within rtol={KERNEL_RTOL} atol={KERNEL_ATOL} ({card})",
          flush=True)
    return nan_cols


def _masked_solve_inputs(torch, P, X, n, seed):
    """The solve inputs of a real masked half-update of the first ``n``
    columns of provider ``P`` against factor ``X``: ``a_full``, the packed
    corrections ``packed_t`` (npairs, n), ``iu``, B from the kept entries;
    a warm X0 with zeros, 5% of the columns masked out."""
    from singlet_tpu_torch.ops import linalg
    from singlet_tpu_torch.ops.rngmask import seed_pair

    k = X.shape[1]
    iu = linalg.triu_pairs(k)
    m = P.mask_tile(seed_pair(MASKED["mask_seed"]), 0, n,
                    MASKED["inv_density"])
    B = torch.where(m, 0.0, P.col_block(0, n).T) @ X
    packed_t = linalg.mask_dot_t(linalg.packed_outer_products(X, iu), m, 1)
    rng = np.random.default_rng(seed)
    X0 = (rng.random((n, k)) * (rng.random((n, k)) < 0.5)).astype(np.float32)
    mask = rng.random(n) >= 0.05
    dev = X.device
    return linalg.gram(X), packed_t, iu, B, \
        torch.as_tensor(X0, device=dev), torch.as_tensor(mask, device=dev)


def _nan_to_zero(x):
    """x with its NaNs (and only those) as 0: with equal NaN masks, two
    results are the same bits where they are numbers."""
    import torch

    return torch.nan_to_num(x, nan=0.0, posinf=float("inf"),
                            neginf=float("-inf"))


def _b2_check(torch, label, a_full, packed_t, iu, B, X0, kw, plain=True):
    """Kernel B2 on one problem: the packed entry (the masked
    half-updates' route) the same bits as the tile entry on the unpacked
    Grams, masked columns X0, within KERNEL_RTOL/KERNEL_ATOL of the plain
    version. Returns (the unpacked tile, the packed entry's X, the plain
    X and per-column sweeps, or None without ``plain``)."""
    from singlet_tpu_torch.ops import linalg, nnls
    from singlet_tpu_torch.ops.nnls_cuda import (
        nnls_batch_cuda_batched_at, nnls_batch_cuda_batched_packed_t)

    k, mask = B.shape[1], kw["update_mask"]
    at = linalg.unpack_sym_from_t(packed_t, k, iu, a_full)
    Xk = nnls_batch_cuda_batched_packed_t(a_full, packed_t, iu, B, X0, **kw)
    Xt = nnls_batch_cuda_batched_at(at, B, X0, **kw)
    torch.cuda.synchronize()
    if not (torch.equal(torch.isnan(Xk), torch.isnan(Xt))
            and torch.equal(_nan_to_zero(Xk), _nan_to_zero(Xt))):
        raise AssertionError(f"B2 {label}: the packed entry differs from "
                             "the tile entry")
    if not torch.equal(Xk[~mask], X0[~mask]):
        raise AssertionError(f"B2 {label}: masked rows differ from X0")
    if not plain:
        return at, Xk, None
    Xp, sweeps = nnls.nnls_batch(at.permute(2, 1, 0), B, X0,
                                 return_sweeps=True, **kw)
    np.testing.assert_allclose(Xk.cpu().numpy(), Xp.cpu().numpy(),
                               rtol=KERNEL_RTOL, atol=KERNEL_ATOL)
    return at, Xk, (Xp, sweeps)


def phase_kernel_b2(torch, card, Ap, Atp, W0):
    """Kernel B2 on the solve inputs of real masked half-updates of the
    bench operand (``B2_SHAPES``, both sweep caps): ``_b2_check``, then
    CUDA-event times of the packed entry (``ms``, the route of the masked
    half-updates), of the tile entry on the unpacked Grams (``tile_ms``),
    of the unpack alone (``unpack_ms``; the parent ran the unpack and then
    its kernel) and of the plain version, with the bound of the packed
    entry's inputs."""
    from singlet_tpu_torch.ops import linalg, nnls
    from singlet_tpu_torch.ops.nnls_cuda import (
        nnls_batch_cuda_batched_at, nnls_batch_cuda_batched_packed_t)

    # factors as wide as the widest shape: W0, then U(0, 1) columns
    k_top = max(k for _, k, _ in B2_SHAPES)
    rng = np.random.default_rng(5)
    H0 = torch.as_tensor(rng.random((Ap.cols_pad, k_top), dtype=np.float32),
                         device="cuda")
    W = np.zeros((Ap.rows_pad, k_top), np.float32)
    W[: W0.shape[0]] = np.concatenate(
        [W0, rng.random((W0.shape[0], k_top - W0.shape[1]),
                        dtype=np.float32)], axis=1)
    W = torch.as_tensor(W, device="cuda")
    rows = []
    for n, k, side in B2_SHAPES:
        # a w-side call solves genes against H, an h-side one cells against W
        P, X = (Atp, H0[:, :k]) if side == "w" else (Ap, W[:, :k])
        a_full, packed_t, iu, B, X0, mask = _masked_solve_inputs(
            torch, P, X.contiguous(), n, seed=n + k)
        npairs = packed_t.shape[0]
        for cap in B2_SWEEP_CAPS:
            kw = dict(L1=0.01, L2=0.001, update_mask=mask,
                      sweep_cap=float(cap))
            at, Xk, (Xp, sweeps) = _b2_check(
                torch, f"n={n} k={k} cap={cap}", a_full, packed_t, iu, B, X0,
                kw)
            err = float((Xk - Xp).abs().max())
            ms = _median_ms(torch, lambda: nnls_batch_cuda_batched_packed_t(
                a_full, packed_t, iu, B, X0, **kw), runs=10)
            tile_ms = _median_ms(torch, lambda: nnls_batch_cuda_batched_at(
                at, B, X0, **kw), runs=10)
            unpack_ms = _median_ms(torch, lambda: linalg.unpack_sym_from_t(
                packed_t, k, iu, a_full), runs=10)
            plain_ms = _median_ms(torch, lambda: nnls.nnls_batch(
                at.permute(2, 1, 0), B, X0, **kw), runs=1 if n > 4096 else 2)
            rows.append(dict(n=n, k=k, side=side, sweep_cap=cap,
                             max_abs_err=err, ms=ms, tile_ms=tile_ms,
                             unpack_ms=unpack_ms, plain_ms=plain_ms,
                             library_ms=None, **_nnls_bound(
                                 sweeps, n, k, k * k + npairs * n)))
            print(f"kernel B2 n={n} k={k} cap={cap}: max|err|={err:.3e} "
                  f"packed entry {ms:.4f} ms, tile entry {tile_ms:.4f} ms "
                  f"(+ unpack {unpack_ms:.4f} ms), plain {plain_ms:.3f} ms, "
                  f"bound {rows[-1]['bound_ms']:.4f} ms ({card})",
                  flush=True)
            del at
        if (n, k, side) in B2_L1_SHAPES:
            # a per-coordinate (n, k) L1 (batch mode) on both entries
            L1 = 0.005 + 0.01 * torch.rand(
                (n, k), generator=torch.Generator(device="cuda")
                .manual_seed(k), device="cuda")
            kw = dict(L1=L1, L2=0.001, update_mask=mask,
                      sweep_cap=float(B2_SWEEP_CAPS[0]))
            at, Xk, (Xp, _) = _b2_check(
                torch, f"n={n} k={k} (n, k) L1", a_full, packed_t, iu, B, X0,
                kw)
            err = float((Xk - Xp).abs().max())
            ms = _median_ms(torch, lambda: nnls_batch_cuda_batched_packed_t(
                a_full, packed_t, iu, B, X0, **kw), runs=10)
            rows.append(dict(n=n, k=k, side=side, sweep_cap=kw["sweep_cap"],
                             l1_array=True, max_abs_err=err, ms=ms))
            print(f"kernel B2 n={n} k={k} cap={kw['sweep_cap']:g} (n, k) "
                  f"L1: max|err|={err:.3e}, packed entry {ms:.4f} ms, the "
                  f"tile entry's bits ({card})", flush=True)
            del at
    # a zero Gram diagonal: the plain version's NaN columns, both entries
    for n, k, z in ZERO_DIAG_B2:
        a_full, packed_t, iu, B, X0, mask = _zero_diag_packed(torch, n, k, z,
                                                              seed=n + z)
        kw = dict(L1=0.01, L2=0.001, update_mask=mask,
                  sweep_cap=float(B2_SWEEP_CAPS[0]))
        at, Xk, _ = _b2_check(torch, f"n={n} k={k} zero diagonal", a_full,
                              packed_t, iu, B, X0, kw, plain=False)
        _nan_gate(torch, f"B2 n={n} k={k} zero diagonal at {z}", Xk,
                  nnls.nnls_batch(at.permute(2, 1, 0), B, X0, **kw), mask,
                  X0, card)
        del at
    return rows


def phase_masked_parity(torch):
    import singlet_tpu_torch as stt

    rng = np.random.default_rng(0)
    A = np.log1p(rng.poisson(0.1, (2000, 1500))).astype(np.float32)
    w_init = rng.random((2000, 10)).astype(np.float32)
    kw = dict(w_init=w_init, inv_density=20, trace_test_mse=1, tol=0.0,
              maxit=5)
    r_gpu = stt.ard_nmf_fit(A, 10, device="cuda", **kw)
    r_cpu = stt.ard_nmf_fit(A, 10, device="cpu", **kw)
    if r_gpu.iter != r_cpu.iter:
        raise AssertionError(f"masked parity: iter {r_gpu.iter} on the card, "
                             f"{r_cpu.iter} on the CPU")
    for name in ("test_mse", "tol", "w", "h"):
        np.testing.assert_allclose(getattr(r_gpu, name), getattr(r_cpu, name),
                                   rtol=FIT_RTOL, atol=FIT_ATOL,
                                   err_msg=name)
    print(f"masked parity 2000x1500 k=10 maxit=5: cuda vs cpu within "
          f"rtol={FIT_RTOL} atol={FIT_ATOL}; iter {r_gpu.iter}, test mse "
          f"{r_gpu.test_mse}", flush=True)
    return dict(iter=r_gpu.iter, test_mse_cuda=r_gpu.test_mse,
                test_mse_cpu=r_cpu.test_mse)


def phase_parity(torch):
    import singlet_tpu_torch as stt

    rng = np.random.default_rng(0)
    A = np.log1p(rng.poisson(0.1, (2000, 1500))).astype(np.float32)
    w_init = rng.random((2000, 10)).astype(np.float32)
    kw = dict(rank=10, tol=0.0, maxit=5, w_init=w_init)
    m_gpu = stt.run_nmf(A, device="cuda", **kw)
    m_cpu = stt.run_nmf(A, device="cpu", **kw)
    for f in ("w", "h", "d"):
        np.testing.assert_allclose(getattr(m_gpu, f), getattr(m_cpu, f),
                                   rtol=FIT_RTOL, atol=FIT_ATOL, err_msg=f)
    fkw = dict(tol=0.0, maxit=5, w_init=w_init)
    t_gpu = stt.nmf_fit(A, 10, device="cuda", **fkw).tol_trace
    t_cpu = stt.nmf_fit(A, 10, device="cpu", **fkw).tol_trace
    np.testing.assert_allclose(t_gpu, t_cpu, rtol=FIT_RTOL, atol=FIT_ATOL)
    print(f"parity 2000x1500 k=10 maxit=5: cuda vs cpu within "
          f"rtol={FIT_RTOL} atol={FIT_ATOL}; tol trace {t_gpu}", flush=True)
    return dict(tol_trace_cuda=t_gpu, tol_trace_cpu=t_cpu)


def _bench_operand():
    """The bench.py operand: 7% dense, values U(0.1, 3.0), and W0 U(0, 1),
    made with numpy from a fixed seed."""
    g, c, k = BENCH["genes"], BENCH["cells"], BENCH["k"]
    rng = np.random.default_rng(BENCH["seed"])
    keep = rng.random((g, c), dtype=np.float32) < BENCH["density"]
    A = rng.random((g, c), dtype=np.float32) * np.float32(2.9) + \
        np.float32(0.1)
    A[~keep] = 0.0
    W0 = rng.random((g, k), dtype=np.float32)
    return A, W0


def _check_fit(w, d, h, shape_w, shape_h):
    for name, x, shape in (("w", w, shape_w), ("h", h, shape_h),
                           ("d", d, (shape_w[1],))):
        if x.shape != shape:
            raise AssertionError(f"{name} has shape {x.shape}, want {shape}")
        if not np.isfinite(x).all() or (x < 0).any():
            raise AssertionError(f"{name} has non-finite or negative values")


def phase_bench(torch, card, A, W0, Ap, Atp, setup_s):
    import singlet_tpu_torch as stt

    g, c, k = BENCH["genes"], BENCH["cells"], BENCH["k"]

    def counted(fn):
        out, secs, n = _counted(torch, fn)
        if n["B2"]:
            raise AssertionError(f"the plain fit launched B2 {n['B2']} times")
        return out, secs, n["B1"], n["plain"]

    # the user's entry point on the numpy operand (2 iterations)
    model, secs, launches, plain = counted(lambda: stt.run_nmf(
        A, rank=k, tol=0.0, maxit=2, w_init=W0, device="cuda"))
    _check_fit(model.w, model.d, model.h, (g, k), (k, c))
    if not (np.diff(model.d) <= 0).all():
        raise AssertionError("run_nmf d is not sorted decreasing")
    if launches != 4 or plain != 0:
        raise AssertionError(f"run_nmf maxit=2: {launches} kernel launches, "
                             f"{plain} plain calls; want 4 and 0")
    print(f"run_nmf {g}x{c} k={k} maxit=2 from numpy: {secs:.3f} s "
          f"(incl. upload) ({card})", flush=True)

    out = {"card": card, "setup_s": setup_s, "run_nmf_maxit2_s": secs}
    for label, tol, maxit in (("fixed10", 0.0, 10), ("race", 1e-5, 1000)):
        torch.cuda.reset_peak_memory_stats()
        res, secs, launches, plain = counted(lambda: stt.nmf_fit(
            Ap, k, At=Atp, w_init=W0, tol=tol, maxit=maxit))
        _check_fit(res.w, res.d, res.h, (g, k), (k, c))
        if launches != 2 * res.n_iter or plain != 0:
            raise AssertionError(
                f"{label}: {launches} kernel launches and {plain} plain "
                f"calls for {res.n_iter} iterations; want "
                f"{2 * res.n_iter} and 0")
        if not res.tol_trace[-1] < res.tol_trace[0]:
            raise AssertionError(f"{label}: tol did not fall: "
                                 f"{res.tol_trace[0]} -> {res.tol_trace[-1]}")
        ms_per_iter = secs * 1e3 / res.n_iter
        out[label] = dict(
            tol=tol, maxit=maxit, n_iter=res.n_iter, wall_s=secs,
            ms_per_iter=ms_per_iter, cells_per_s=c * 1e3 / ms_per_iter,
            final_tol=res.tol_trace[-1], launches=launches,
            peak_mem_gib=torch.cuda.max_memory_allocated() / 2**30)
        print(f"fit {label} {g}x{c} k={k} tol={tol} maxit={maxit}: "
              f"{res.n_iter} iterations in {secs:.3f} s, "
              f"{ms_per_iter:.3f} ms/iteration, "
              f"{c * 1e3 / ms_per_iter:.0f} cells/s, final tol "
              f"{res.tol_trace[-1]:.3e}, B1 launches {launches} ({card})",
              flush=True)
    out["race_profile"] = _profile(torch, card, lambda: stt.nmf_fit(
        Ap, k, At=Atp, w_init=W0, tol=1e-5, maxit=1000))
    return out


def phase_masked(torch, card, Ap, Atp, W0):
    import singlet_tpu_torch as stt
    from singlet_tpu_torch.ops.rngmask import seed_pair

    k, inv = MASKED["k"], MASKED["inv_density"]
    g, c = Ap.rows_true, Ap.cols_true
    # the test mask: built once per (seed, inv_density), then cached (the
    # B2 phase built it already: drop it to time the build)
    Ap.mask_cache.clear()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    mask = Ap.test_mask(seed_pair(MASKED["mask_seed"]), inv)
    torch.cuda.synchronize()
    mask_s = time.perf_counter() - t0
    mask_mib = mask.numel() * mask.element_size() / 2**20
    print(f"test mask {tuple(mask.shape)} bool: built in {mask_s:.3f} s, "
          f"{mask_mib:.1f} MiB, density {float(mask.float().mean()):.5f} "
          f"({card})", flush=True)

    # the bench operand has no low-rank structure, so its test error may
    # rise from the first iteration on; a threshold of 1 (the score is
    # below 1) keeps the early stop off, and the fit runs maxit iterations
    fit_kw = dict(At=Atp, w_init=W0, mask_seed=MASKED["mask_seed"],
                  inv_density=inv, tol=0.0, trace_test_mse=1,
                  overfit_threshold=1.0)
    torch.cuda.reset_peak_memory_stats()
    res, secs, n = _counted(torch, lambda: stt.ard_nmf_fit(
        Ap, k, maxit=MASKED["maxit"], **fit_kw))
    _check_fit(res.w, res.d, res.h, (g, k), (k, c))
    steps = len(res.iter)      # trace every iteration: one entry per step
    blocks = Ap.cols_pad // Ap.block + Atp.cols_pad // Atp.block
    if steps != MASKED["maxit"] or n["B2"] != blocks * steps or n["B1"] \
            or n["plain"]:
        raise AssertionError(
            f"masked fit: {n} launches for {steps} iterations; want "
            f"{MASKED['maxit']} iterations, B2 = {blocks} x {steps}, B1 = 0, "
            f"plain = 0")
    if not (np.isfinite(res.test_mse).all() and min(res.test_mse) > 0):
        raise AssertionError(f"masked fit: test mse {res.test_mse}")
    ms_per_iter = secs * 1e3 / steps
    out = {"mask_build_s": mask_s, "mask_mib": mask_mib, "fit": dict(
        k=k, steps=steps, wall_s=secs, ms_per_iter=ms_per_iter,
        launches=n, b2_per_iter=n["B2"] / steps, test_mse=res.test_mse,
        tol=res.tol, peak_mem_gib=torch.cuda.max_memory_allocated() / 2**30)}
    print(f"masked fit {g}x{c} k={k} maxit={MASKED['maxit']}: {steps} "
          f"iterations in {secs:.3f} s, {ms_per_iter:.3f} ms/iteration, "
          f"launches {n}; test mse {res.test_mse} ({card})", flush=True)
    out["profile"] = _profile(torch, card, lambda: stt.ard_nmf_fit(
        Ap, k, maxit=3, **fit_kw), label="masked fit, 3 iterations")

    df, secs, n = _counted(torch, lambda: stt.cross_validate_nmf(
        (Ap, Atp), ranks=CV_RANKS, n_replicates=1, maxit=20, verbose=0))
    if sorted(df["k"].unique()) != CV_RANKS or \
            not np.isfinite(df["test_error"]).all():
        raise AssertionError(f"cross_validate_nmf frame:\n{df}")
    if not n["B2"] or n["B1"] or n["plain"]:
        raise AssertionError(f"cross_validate_nmf launches {n}")
    best = stt.GetBestRank(df)
    last = df.sort_values("iter").groupby("k").last()
    out["cv"] = dict(ranks=CV_RANKS, wall_s=secs, launches=n, best_rank=best,
                     rows=len(df), last_test_error={
                         int(kk): float(v) for kk, v in
                         last["test_error"].items()},
                     iters={int(kk): int(v) for kk, v in
                            last["iter"].items()})
    print(f"cross_validate_nmf ranks {CV_RANKS} maxit=20: {secs:.3f} s, "
          f"launches {n}, GetBestRank {best}, last test error "
          f"{out['cv']['last_test_error']} ({card})", flush=True)
    return out


def _planted_operand(genes, cells, rank, seed):
    """A nonnegative operand of planted rank: sparse gamma programs W, gamma
    H, Gaussian noise at 5% of the signal's spread, 20% dropout. The recipe
    selects the planted rank on the CPU at 1200 x 800 with both packages."""
    rng = np.random.default_rng(seed)
    W = (rng.gamma(0.5, 1.0, (genes, rank))
         * (rng.random((genes, rank)) < 0.5)).astype(np.float32)
    H = rng.gamma(1.0, 1.0, (rank, cells)).astype(np.float32)
    A = W @ H
    A += np.float32(0.05) * A.std() * rng.standard_normal(
        (genes, cells), dtype=np.float32)
    A[rng.random((genes, cells), dtype=np.float32) < 0.2] = 0.0
    return np.maximum(A, 0.0, out=A)


def phase_ard(torch, card):
    import singlet_tpu_torch as stt

    g, c = BENCH["genes"], BENCH["cells"]
    rank = PLANTED["rank"]
    t0 = time.perf_counter()
    A = _planted_operand(g, c, rank, PLANTED["seed"])
    make_s = time.perf_counter() - t0
    model, secs, n = _counted(torch, lambda: stt.ard_nmf(
        A, k_max=PLANTED["k_max"], verbose=0, seed=1, device="cuda"))
    ranks = sorted(int(kk) for kk in model.cv_data["k"].unique())
    _check_fit(model.w, model.d, model.h, (g, model.k), (model.k, c))
    if abs(model.k - rank) > 2:
        raise AssertionError(f"ard_nmf selected rank {model.k}, planted "
                             f"{rank}; fitted ranks {ranks}")
    if not n["B2"] or not n["B1"] or n["plain"]:
        raise AssertionError(f"ard_nmf launches {n}")
    print(f"ard_nmf on a planted rank-{rank} {g}x{c} operand: selected "
          f"rank {model.k} after fits at ranks {ranks}, {secs:.3f} s "
          f"(operand made in {make_s:.1f} s), launches {n} ({card})",
          flush=True)
    return dict(planted=rank, selected=model.k, ranks=ranks,
                fits=len(ranks), wall_s=secs, launches=n,
                cv_rows=len(model.cv_data)), A, model


def phase_bell_kernels(torch, card, label, li, lv, k, gene_block, n_gb,
                       cell_offset):
    """B3 and B4 against their plain versions on planes ``li``/``lv`` (a
    column slice at ``cell_offset`` of an operand's planes, ``n_gb`` gene
    blocks), plain and masked; the same bits on a second run; then values
    1.0 with 0/1 indicator factors, where every sum is a small integer and
    kernel and plain version must be equal."""
    from singlet_tpu_torch.ops import bell, bell_cuda
    from singlet_tpu_torch.ops.rngmask import seed_pair

    cells = li.shape[1]
    width = li.shape[0] // n_gb
    genes = n_gb * gene_block
    gen = torch.Generator(device="cuda").manual_seed(k)
    W = torch.rand((genes, k), generator=gen, device="cuda")
    H = torch.rand((cells, k), generator=gen, device="cuda")
    # the library call's operands: CSR copies of the operand, unmasked and
    # keep-masked (the hashed mask at the nonzeros is the packed one there)
    words = _slice_words(torch, cell_offset, cells, genes, gene_block)
    csr = {False: _csr_pair(torch, li, lv, gene_block, n_gb),
           True: _csr_pair(torch, li, lv, gene_block, n_gb, words)}
    kernels = (("B3", bell_cuda.bell_spmm_cuda, bell.bell_spmm_plain, {}),
               ("B4", bell_cuda.bell_spmm_t_cuda, bell.bell_spmm_t_plain,
                {"n_gb": n_gb}))
    rows = []
    for masked in (False, True):
        seed = seed_pair(MASKED["mask_seed"]) if masked else None
        for name, kern, plain, extra in kernels:
            X = W if name == "B3" else H

            def call(f, X=X, extra=extra, seed=seed):
                return f(li, lv, X, seed, cell_offset, gene_block=gene_block,
                         inv_density=MASKED["inv_density"], **extra)

            got, again, want = call(kern), call(kern), call(plain)
            torch.cuda.synchronize()
            err = float((got - want).abs().max())
            scale = float(want.abs().max())
            if not err <= BELL_TOL * scale:
                raise AssertionError(f"{name} {label} masked={masked}: max "
                                     f"abs err {err} > {BELL_TOL} x {scale}")
            if not torch.equal(got, again):
                raise AssertionError(f"{name} {label} masked={masked}: two "
                                     "runs differ")
            ms = _median_ms(torch, lambda: call(kern), runs=20)
            plain_ms = _median_ms(torch, lambda: call(plain), runs=3)
            library_ms, nnz, lib_err, lib = _spmm_library(
                torch, csr[masked], name, X, got)
            if not lib_err <= BELL_TOL * scale:
                raise AssertionError(f"{name} {label} masked={masked}: the "
                                     f"library call differs by {lib_err}")
            extra_row = {}
            if name == "B3" and not masked:
                # which way B3 falls against its library call, with the
                # spread of the ratio, as B5's
                extra_row["turns"] = t = _turns(torch, lambda: call(kern),
                                                lib)
                print(f"kernel B3 {label} in turns with torch.sparse.mm: "
                      f"{t['kernel_ms']} against {t['library_ms']} ms, "
                      f"ratio of the medians {t['ratio']:.4f} ({card})",
                      flush=True)
            rows.append(dict(shape=label, kernel=name, masked=masked,
                             cells=cells, k=k, width=width,
                             max_abs_err=err, max_abs_out=scale, ms=ms,
                             plain_ms=plain_ms, library_ms=library_ms,
                             **extra_row,
                             **_bound(2 * li.numel() * 4
                                      + (genes + cells) * k * 4,
                                      2 * nnz * k, F32_OPS_S)))
            print(f"kernel {name} {label} cells={cells} k={k} width={width} "
                  f"masked={masked}: max|err|={err:.3e} (max|out| "
                  f"{scale:.3e}), same bits twice, kernel {ms:.4f} ms, "
                  f"plain {plain_ms:.3f} ms, torch.sparse.mm "
                  f"{library_ms:.4f} ms, bound {rows[-1]['bound_ms']:.4f} ms "
                  f"({card})", flush=True)

    # values 1.0 at the live slots; a contiguous copy of the ids, since
    # the kernels take both planes with one row stride
    li = li.contiguous()
    ones = torch.where(li >= 0, 1.0, 0.0)
    Wi = torch.zeros((genes, 7), device="cuda")
    Wi[torch.arange(genes), torch.arange(genes) % 7] = 1.0
    Hi = torch.zeros((cells, 7), device="cuda")
    Hi[torch.arange(cells), torch.arange(cells) % 7] = 1.0
    seed = seed_pair(MASKED["mask_seed"])
    kw = dict(gene_block=gene_block, inv_density=MASKED["inv_density"])
    for name, kern, plain, extra in kernels:
        X = Wi if name == "B3" else Hi
        if not torch.equal(kern(li, ones, X, seed, cell_offset, **kw, **extra),
                           plain(li, ones, X, seed, cell_offset, **kw,
                                 **extra)):
            raise AssertionError(f"{name} {label}: the 0/1 case differs")
    print(f"kernels B3 B4 {label}: 0/1 values with indicator factors, masked, "
          f"equal to the plain versions", flush=True)
    return rows


def _csr_pair(torch, li, lv, gene_block, n_gb, words=None):
    """The (keep-masked, with ``words``) operand of planes ``li``/``lv`` as
    CSR copies, (cells, genes) and (genes, cells), and its nonzero count:
    the operands of the library call (torch.sparse.mm), built outside the
    timing."""
    width = li.shape[0] // n_gb
    r, c = torch.nonzero(li >= 0, as_tuple=True)
    gb = r // width
    local = li[r, c].long()
    if words is not None:
        w = words[c, (gb // 32) * gene_block + local].long() & 0xFFFFFFFF
        keep = ((w >> (gb % 32)) & 1) == 0
        r, c, gb, local = r[keep], c[keep], gb[keep], local[keep]
    gene = gb * gene_block + local
    vals = lv[r, c]
    cells, genes = li.shape[1], n_gb * gene_block
    coo = torch.sparse_coo_tensor(torch.stack([c, gene]), vals,
                                  (cells, genes)).coalesce()
    coo_t = torch.sparse_coo_tensor(torch.stack([gene, c]), vals,
                                    (genes, cells)).coalesce()
    return coo.to_sparse_csr(), coo_t.to_sparse_csr(), int(vals.numel())


def _bound(bytes_, ops, peak):
    """The least time the card could take: the larger of the bytes over
    the memory rate and the operations over the peak rate of their type
    (NVIDIA's published peaks for the H100 SXM at 700 W)."""
    t_bytes, t_ops = bytes_ / HBM_BYTES_S, ops / peak
    return dict(bound_ms=max(t_bytes, t_ops) * 1e3,
                bound_by="bytes" if t_bytes >= t_ops else "operations",
                bytes=int(bytes_), ops=int(ops))


def _slice_words(torch, cell_offset, cells, genes, gene_block,
                 cells_true=None, genes_true=None):
    """The packed test mask (MASKED's seed and density) of cells
    [cell_offset, cell_offset + cells) of an operand, all genes."""
    from singlet_tpu_torch.ops.maskbits import pack_mask_words
    from singlet_tpu_torch.ops.rngmask import seed_pair

    return pack_mask_words(
        seed_pair(MASKED["mask_seed"]),
        torch.arange(cell_offset, cell_offset + cells, device="cuda"),
        genes_pad=genes, gene_block=gene_block,
        inv_density=MASKED["inv_density"],
        cells_true=cell_offset + cells if cells_true is None else cells_true,
        genes_true=genes if genes_true is None else genes_true)


def _spmm_library(torch, csr, name, X, got):
    """torch.sparse.mm on the CSR copy for B3/B5 (operand @ W) or B4/B6
    (operand^T @ H): (median ms, nonzeros, max abs difference to the
    kernel's ``got``, the call)."""
    A_csr, A_csr_t, nnz = csr
    mat = A_csr if name in ("B3", "B5") else A_csr_t

    def lib():
        return torch.sparse.mm(mat, X)

    err = float((lib() - got).abs().max())
    return _median_ms(torch, lib, runs=10), nnz, err, lib


def _turns(torch, kernel, library, rounds=3, runs=10):
    """A kernel and its library call timed in turns (kernel, library,
    library, kernel, ``rounds`` times), each turn the median of ``runs``
    calls by CUDA events: both lists of turns, their medians and the
    ratio of the medians, kernel over library."""
    turns = {"kernel": [], "library": []}
    for _ in range(rounds):
        for name in ("kernel", "library", "library", "kernel"):
            fn = kernel if name == "kernel" else library
            turns[name].append(_median_ms(torch, fn, runs=runs))
    med = {name: statistics.median(ts) for name, ts in turns.items()}
    return dict(kernel_ms=turns["kernel"], library_ms=turns["library"],
                kernel_median_ms=med["kernel"],
                library_median_ms=med["library"],
                ratio=med["kernel"] / med["library"])


def _int_mm_library(torch, m_i8, P_i8):
    """One torch._int_mm of an unpacked int8 mask operand with an int8
    packed operand (both prepared outside the timing), padded to its
    multiples of 8: median ms."""
    pad = (-P_i8.shape[1]) % 8
    if pad:
        P_i8 = torch.nn.functional.pad(P_i8, (0, pad))
    return _median_ms(torch, lambda: torch._int_mm(m_i8, P_i8), runs=10)


def phase_pairs(torch, card):
    """Phase 3b: the bits route's pair operands (``quantized_pairs_cuda``)
    at PAIRS_SHAPES, int8 and bf16, into a ``kmajor_buffer`` or a
    ``pair_buffer``: the same bits as the eager chain (the plain version
    on the card), one launch a call; the kernel's device time by
    ``_device_ms``, its bound (X read, the operand and its scales written,
    once each) and the chain's time by ``_median_ms``. One row a (shape,
    dtype)."""
    from singlet_tpu_torch.ops import maskgram, maskgram_cuda

    gen = torch.Generator(device="cuda").manual_seed(24)
    rows = []
    for n, k, label in PAIRS_SHAPES:
        X = torch.rand((n, k), generator=gen, device="cuda")
        npairs = k * (k + 1) // 2
        for dtype in ("int8", "bf16"):
            make = maskgram.kmajor_buffer if dtype == "int8" \
                else maskgram.pair_buffer
            out, ref = make(n, npairs, "cuda"), make(n, npairs, "cuda")
            s = torch.empty(npairs, device="cuda")
            s_ref = torch.empty_like(s)
            launches = maskgram_cuda.LAUNCHES_PAIRS
            maskgram_cuda.quantized_pairs_cuda(X, out, s)
            maskgram.quantized_pairs_plain(X, ref, s_ref)
            torch.cuda.synchronize()
            if maskgram_cuda.LAUNCHES_PAIRS != launches + 1:
                raise AssertionError("quantized_pairs: not one launch")
            err = max(float((out.float() - ref.float()).abs().max()),
                      float((s - s_ref).abs().max()))
            if not (torch.equal(out, ref) and torch.equal(s, s_ref)):
                raise AssertionError(f"quantized_pairs {label} ({n} x {k}, "
                                     f"{dtype}): differs from the chain by "
                                     f"{err}")
            ms = _device_ms(
                torch, lambda: maskgram_cuda.quantized_pairs_cuda(X, out, s))
            plain_ms = _median_ms(
                torch, lambda: maskgram.quantized_pairs_plain(X, ref, s_ref),
                runs=5)
            width = 1 if dtype == "int8" else 2
            row = dict(kernel="pairs", shape=label, n=n, k=k, dtype=dtype,
                       ms=ms, plain_ms=plain_ms, library_ms=None,
                       max_abs_err=err,
                       **_bound(4 * n * k + width * n * npairs + 4 * npairs,
                                n * npairs, F32_OPS_S))
            rows.append(row)
            print(f"quantized_pairs {label} {n} x {k} ({npairs} pairs, "
                  f"{dtype}): {ms * 1e3:.1f} us on the card, bound "
                  f"{row['bound_ms'] * 1e3:.1f} us ({row['bound_by']}), the "
                  f"eager chain {plain_ms:.3f} ms; the same bits ({card})",
                  flush=True)
            del out, ref
    return rows


def phase_bits_kernels(torch, card, label, li, lv, k, gene_block, n_gb,
                       cell_offset, block=2048, timed=True):
    """Kernels B5-B9 and B12-B14 against their plain versions on the card,
    on planes ``li``/``lv`` (a column slice at ``cell_offset`` of an
    operand's planes) and the packed test mask of those cells: B5 and B6
    against masked B3 and B4 (the same bits) and their plain versions; B7
    (its sums within rtol 2e-4, atol 1e-5, its counts equal); B12 (the same
    bytes); B8 and B13 on the first ``block`` cells and B9 and B14 over all
    of them in groups of ``block`` (each group its own quantization, as the
    engine batches them), on int8 (the same bits as the plain versions, and
    B13/B14 those of B8/B9) and bf16 (within 1e-5 x max |out|). With
    ``timed``, the times of kernel, plain version and library call, and
    each kernel's bound."""
    from singlet_tpu_torch.ops import (bell, bell_cuda, maskbits, maskgram,
                                       maskgram_cuda)
    from singlet_tpu_torch.ops.linalg import packed_outer_products, triu_pairs
    from singlet_tpu_torch.ops.maskbits import unpack_all
    from singlet_tpu_torch.ops.rngmask import seed_pair

    cells = li.shape[1]
    genes = n_gb * gene_block
    width = li.shape[0] // n_gb
    G = gene_block
    gen = torch.Generator(device="cuda").manual_seed(k + 1)
    W = torch.rand((genes, k), generator=gen, device="cuda")
    H = torch.rand((cells, k), generator=gen, device="cuda")
    Wd = W / k
    words = _slice_words(torch, cell_offset, cells, genes, G)
    seed = seed_pair(MASKED["mask_seed"])
    inv = MASKED["inv_density"]
    plane_bytes = 2 * li.numel() * 4
    word_bytes = words.numel() * 4
    rows = []

    def record(name, err, scale, ms=None, plain_ms=None, library_ms=None,
               bound=None, **extra):
        row = dict(shape=label, kernel=name, cells=cells, k=k, width=width,
                   n_gb=n_gb, max_abs_err=err, max_abs_out=scale, **extra)
        if timed:
            row.update(ms=ms, plain_ms=plain_ms, library_ms=library_ms,
                       **bound)
        rows.append(row)
        times = "" if not timed else (
            f", kernel {ms:.4f} ms, plain {plain_ms:.3f} ms, library "
            f"{'none' if library_ms is None else f'{library_ms:.4f} ms'}, "
            f"bound {bound['bound_ms']:.4f} ms ({bound['bound_by']})")
        print(f"kernel {name} {label} cells={cells} k={k} n_gb={n_gb} "
              f"{extra}: max|err|={err:.3e} (max|out| {scale:.3e}){times} "
              f"({card})", flush=True)

    def timing(kern, plain, runs=20, plain_runs=3):
        if not timed:
            return {}
        return dict(ms=_median_ms(torch, kern, runs=runs),
                    plain_ms=_median_ms(torch, plain, runs=plain_runs))

    # B5 and B6: the same bits as masked B3 and B4, close to the plain
    # versions
    csr = _csr_pair(torch, li, lv, G, n_gb, words) if timed else None
    for name, kern, plain, hashed, X, extra in (
            ("B5", bell_cuda.bell_spmm_bits_cuda, bell.bell_spmm_bits_plain,
             lambda: bell_cuda.bell_spmm_cuda(li, lv, W, seed, cell_offset,
                                              gene_block=G, inv_density=inv),
             W, {}),
            ("B6", bell_cuda.bell_spmm_t_bits_cuda,
             bell.bell_spmm_t_bits_plain,
             lambda: bell_cuda.bell_spmm_t_cuda(li, lv, H, seed, cell_offset,
                                                gene_block=G, n_gb=n_gb,
                                                inv_density=inv),
             H, {"n_gb": n_gb})):
        def call(f, X=X, extra=extra):
            return f(li, lv, X, words, gene_block=G, **extra)

        got, want = call(kern), call(plain)
        if not torch.equal(got, hashed()):
            raise AssertionError(f"{name} {label}: differs from the masked "
                                 "hashed kernel")
        err, scale = float((got - want).abs().max()), float(want.abs().max())
        if not err <= BELL_TOL * scale:
            raise AssertionError(f"{name} {label}: max abs err {err} > "
                                 f"{BELL_TOL} x {scale}")
        t = timing(lambda: call(kern), lambda: call(plain))
        if timed:
            library_ms, nnz, lib_err, lib = _spmm_library(torch, csr, name,
                                                          X, got)
            if not lib_err <= BELL_TOL * scale:
                raise AssertionError(f"{name} {label}: the library call "
                                     f"differs by {lib_err}")
            t.update(library_ms=library_ms, bound=_bound(
                plane_bytes + word_bytes + (genes + cells) * k * 4,
                2 * nnz * k, F32_OPS_S))
            if name == "B5":
                # which way B5 falls against its library call, with the
                # spread of the ratio
                t["turns"] = _turns(torch, lambda: call(kern), lib)
                print(f"kernel B5 {label} in turns with torch.sparse.mm: "
                      f"{t['turns']['kernel_ms']} against "
                      f"{t['turns']['library_ms']} ms, ratio of the "
                      f"medians {t['turns']['ratio']:.4f} ({card})",
                      flush=True)
        record(name, err, scale, **t)

    # B7: sums close, counts equal, the same bits twice
    def mse(f):
        return f(li, lv, words, Wd, H, gene_block=G)

    got, want = mse(bell_cuda.bell_mse_bits_cuda), mse(bell.bell_mse_bits_plain)
    np.testing.assert_allclose(got[0].cpu().numpy(), want[0].cpu().numpy(),
                               rtol=2e-4, atol=1e-5)
    if not (torch.equal(got[1], want[1])
            and torch.equal(got, mse(bell_cuda.bell_mse_bits_cuda))):
        raise AssertionError(f"B7 {label}: counts differ or two runs differ")
    t = timing(lambda: mse(bell_cuda.bell_mse_bits_cuda),
               lambda: mse(bell.bell_mse_bits_plain))
    held = int(got[1].sum())
    if timed:
        t["bound"] = _bound(plane_bytes + word_bytes
                            + (genes + cells) * k * 4 + 2 * cells * 4,
                            held * (2 * k + 3), F32_OPS_S)
    record("B7", float((got[0] - want[0]).abs().max()),
           float(want[0].abs().max()), held_out=held, **t)

    # B12: the words of all the cells unpacked into the dense int8 mask, the
    # plain version's bytes; one PyTorch call does not compute it
    def b12(f, out=None):
        return f(words, gene_block=G, genes_pad=genes, out=out)

    m8 = b12(maskgram_cuda.unpack_mask_bits_cuda)
    if not torch.equal(m8, b12(maskbits.unpack_mask_bits_plain)):
        raise AssertionError(f"B12 {label}: differs from the plain version")
    m8_buf = torch.empty_like(m8)
    t = timing(lambda: b12(maskgram_cuda.unpack_mask_bits_cuda, m8_buf),
               lambda: b12(maskbits.unpack_mask_bits_plain, m8_buf))
    if timed:
        t.update(library_ms=None, bound=_bound(word_bytes + m8.numel(), 0,
                                               INT8_OPS_S))
        # 5 more turns of 20 calls, for the median and the spread of B12's
        # time against its bound
        t["turns_ms"] = [_median_ms(torch, lambda: b12(
            maskgram_cuda.unpack_mask_bits_cuda, m8_buf), runs=20)
            for _ in range(5)]
        print(f"kernel B12 {label} in 5 turns: {t['turns_ms']} ms, median "
              f"{statistics.median(t['turns_ms']):.4f}, bound "
              f"{t['bound']['bound_ms']:.4f} ms ({card})", flush=True)
    record("B12", 0.0, 1.0, **t)
    del m8_buf

    # B8 and B13 on one block, B9 and B14 over the groups of blocks; the
    # words their passes must give: B10's hash pass of the block's cells
    # (along the genes), B11's of all the cells (along the cells)
    ids = torch.arange(cell_offset, cell_offset + cells, device="cuda")
    hkw = dict(inv_density=inv, cells_true=cell_offset + cells,
               genes_true=genes)
    hash_words = maskgram_cuda.pack_mask_k_cuda(seed, ids, genes,
                                                gene_rows=True, **hkw)
    iu = triu_pairs(k)
    npairs = iu[0].shape[0]
    b = min(block, cells)
    hash_words_blk = maskgram_cuda.pack_mask_k_cuda(seed, ids[:b], genes,
                                                    gene_rows=False, **hkw)
    w_blk = words[:b]
    m8_blk = m8[:b]
    nnz_blk, nnz_all = int(m8_blk.sum()), int(m8.sum())
    Pw = packed_outer_products(W, iu)
    groups = [H[c0:c0 + b] for c0 in range(0, cells, b)]
    acc0 = torch.rand((npairs, genes), generator=gen, device="cuda")
    passes = {
        "B8": (lambda: maskgram_cuda.pack_words_g_cuda(
                   w_blk, gene_block=G, genes_pad=genes),
               lambda: maskgram.pack_words_g(w_blk, gene_block=G,
                                             genes_pad=genes),
               hash_words_blk),
        "B9": (lambda: maskgram_cuda.pack_words_k_cuda(
                   words, gene_block=G, genes_pad=genes),
               lambda: maskgram.pack_words_k(words, gene_block=G,
                                             genes_pad=genes),
               hash_words),
        "B13": (lambda: maskgram_cuda.pack_mask8_g_cuda(m8_blk),
                lambda: maskgram.pack_mask8_g(m8_blk), hash_words_blk),
        "B14": (lambda: maskgram_cuda.pack_mask8_k_cuda(m8),
                lambda: maskgram.pack_mask8_k(m8), hash_words)}
    for dtype in ("int8", "bf16"):
        if dtype == "int8":
            Pw_op, Pw_s = maskgram.quantize_pairs(Pw, axis=0)
            q = [maskgram.quantize_pairs(packed_outer_products(Hg, iu))
                 for Hg in groups]
        else:
            Pw_op = Pw.to(torch.bfloat16)
            Pw_s = torch.ones(npairs, device="cuda")
            q = [(packed_outer_products(Hg, iu).to(torch.bfloat16), Pw_s)
                 for Hg in groups]
        Ph_op = torch.cat([x for x, _ in q])
        Ph_s = torch.stack([x for _, x in q], dim=1).contiguous()
        # the kernels take P as the engine hands it over: int8 K-major,
        # bf16 pair-padded (the checks also feed it contiguous)
        make = (maskgram.kmajor_buffer if dtype == "int8"
                else maskgram.pair_buffer)
        Ph_eng = make(cells, npairs, "cuda")
        Ph_eng.copy_(Ph_op)
        Pw_eng = make(genes, npairs, "cuda")
        Pw_eng.copy_(Pw_op)
        esz = 1 if dtype == "int8" else 2
        peak = INT8_OPS_S if dtype == "int8" else BF16_OPS_S

        def b8(f, acc=None, P=None):
            return f(Pw_eng if P is None else P, Pw_s, w_blk, gene_block=G)

        def b9(f, acc=None, P=None):
            # the carry is updated in place: a fresh copy for the checks,
            # one reused buffer for the timings
            return f(Ph_eng if P is None else P, Ph_s, words,
                     acc0.clone() if acc is None else acc, gene_block=G,
                     scale_block=b)

        def b13(f, acc=None, P=None):
            return f(Pw_eng if P is None else P, Pw_s, m8_blk, gene_block=G)

        def b14(f, acc=None, P=None):
            return f(Ph_eng if P is None else P, Ph_s, m8,
                     acc0.clone() if acc is None else acc, gene_block=G,
                     scale_block=b)

        def checks(name, call, kern, got, want, contiguous):
            """The same bits twice and from contiguous P (int8; bf16 within
            the tolerance), and the kernel's pass alone the words of its
            plain version and of the hash pass; returns the pass's time."""
            again, contig = call(kern), call(kern, P=contiguous)
            if not torch.equal(got, again):
                raise AssertionError(f"{name} {label} {dtype}: two runs "
                                     "differ")
            c_err = float((contig - want).abs().max())
            if (dtype == "int8" and not torch.equal(got, contig)) or \
                    not c_err <= 1e-5 * float(want.abs().max()):
                raise AssertionError(f"{name} {label} {dtype}: contiguous "
                                     f"P differs by {c_err}")
            mask_pass, plain_pass, hashed = passes[name]
            kp = mask_pass()
            if not (torch.equal(kp, plain_pass())
                    and torch.equal(kp, hashed)):
                raise AssertionError(f"{name} pass {label}: differs from "
                                     "its plain version or the hash pass")
            return _median_ms(torch, mask_pass, runs=10) if timed else None

        def library(name, m_i8):
            """The same int32 sums by torch._int_mm on the unpacked mask
            (unpacking and dequantizing outside the timing)."""
            if name in ("B8", "B13"):
                return _int_mm_library(torch, m_i8, Pw_op)
            return _int_mm_library(torch, Ph_op.T.contiguous(), m_i8)

        # B13 and B14 read the unpacked mask: B8's and B9's bits on int8
        # (B13 also on bf16: B8's GEMM on the same words), close on bf16
        for name, call, kern, plain, twin, contiguous, nnz, bytes_, macs in (
                ("B8", b8, maskgram_cuda.mask_packed_w_t_bits_cuda,
                 maskgram.mask_packed_w_t_bits_plain, None, Pw_op, nnz_blk,
                 genes * npairs * esz + npairs * 4 + w_blk.numel() * 4
                 + npairs * b * 4, b * genes * npairs),
                ("B9", b9, maskgram_cuda.mask_packed_h_t_bits_cuda,
                 maskgram.mask_packed_h_t_bits_plain, None, Ph_op, nnz_all,
                 cells * npairs * esz + Ph_s.numel() * 4 + word_bytes
                 + 2 * npairs * genes * 4, cells * genes * npairs),
                ("B13", b13, maskgram_cuda.mask_packed_w_t_m8_cuda,
                 maskgram.mask_packed_w_t_m8_plain,
                 lambda: b8(maskgram_cuda.mask_packed_w_t_bits_cuda), Pw_op,
                 nnz_blk, genes * npairs * esz + npairs * 4 + m8_blk.numel()
                 + npairs * b * 4, b * genes * npairs),
                ("B14", b14, maskgram_cuda.mask_packed_h_t_m8_cuda,
                 maskgram.mask_packed_h_t_m8_plain,
                 lambda: b9(maskgram_cuda.mask_packed_h_t_bits_cuda), Ph_op,
                 nnz_all, cells * npairs * esz + Ph_s.numel() * 4
                 + m8.numel() + 2 * npairs * genes * 4,
                 cells * genes * npairs)):
            got, want = call(kern), call(plain)
            err, scale = float((got - want).abs().max()), \
                float(want.abs().max())
            if dtype == "int8" and not torch.equal(got, want):
                raise AssertionError(f"{name} {label} int8: max abs err "
                                     f"{err}, want the same bits")
            if not err <= 1e-5 * scale:
                raise AssertionError(f"{name} {label} {dtype}: max abs err "
                                     f"{err} > 1e-5 x {scale}")
            extra = {}
            if twin is not None:
                bits_out = twin()
                twin_err = float((got - bits_out).abs().max())
                exact = dtype == "int8" or name == "B13"
                if (exact and not torch.equal(got, bits_out)) or \
                        not twin_err <= 1e-5 * scale:
                    raise AssertionError(
                        f"{name} {label} {dtype}: against "
                        f"{'B8' if name == 'B13' else 'B9'} {twin_err}; "
                        f"want {'the same bits' if exact else 'within 1e-5'}")
                extra["err_vs_bits"] = twin_err
            extra["pass_ms"] = checks(name, call, kern, got, want,
                                      contiguous)
            buf = acc0.clone()
            t = timing(lambda: call(kern, buf), lambda: call(plain, buf),
                       runs=10, plain_runs=2)
            if timed:
                m_i8 = m8_blk if name in ("B8", "B13") else m8
                t.update(library_ms=library(name, m_i8)
                         if dtype == "int8" else None,
                         bound=_bound(bytes_, 2 * nnz * npairs, peak),
                         dense_floor_ms=2 * macs / peak * 1e3)
            record(name, err, scale, dtype=dtype, **extra, **t)
    return rows


def phase_hash_kernels(torch, card, label, k, genes, gene_block, cell_offset,
                       cells, block, cells_true=None, genes_true=None,
                       timed=True):
    """Kernels B10 and B11 against their plain versions on the card, for
    cells [cell_offset, cell_offset + cells) of an operand of ``genes``
    genes with the validity clamps ``cells_true``/``genes_true``: B10 on the
    first ``block`` cells, B11 over all of them block by block into one
    carry, each fed P as the engine feeds it (a view of a buffer whose pair
    axis is padded for TMA). Their hash pass alone gives the plain
    version's words bit for bit (both layouts, the first ``block`` cells);
    each kernel is within 1e-5 x max |output| of its plain version, the same
    bits on a second run, and within 1e-5 x max |output| of bf16 B8 and B9
    (one quantization group per block) fed the packed words of the same
    cells and seed. With ``timed``, per call (one block): the times of
    kernel, hash pass, plain version and library call (torch.matmul of the
    bf16 mask, built outside the timing, with the bf16 operand) and the
    bound; and the kernel in turns with bf16 B8/B9 on the packed words
    (the same GEMM after a pass over the words in place of the hash pass,
    P in the same layout), old, new, new, old."""
    from singlet_tpu_torch.ops import maskgram, maskgram_cuda
    from singlet_tpu_torch.ops.linalg import packed_outer_products, triu_pairs
    from singlet_tpu_torch.ops.maskbits import pack_mask_words
    from singlet_tpu_torch.ops.rngmask import seed_pair

    cells_true = cell_offset + cells if cells_true is None else cells_true
    genes_true = genes if genes_true is None else genes_true
    G = gene_block
    gen = torch.Generator(device="cuda").manual_seed(k + 2)
    iu = triu_pairs(k)
    npairs = iu[0].shape[0]
    # the operands in bf16, as the engine hands them to B8-B11 (views of
    # pair-padded buffers; contiguous for the library call)
    Pw = packed_outer_products(torch.rand((genes, k), generator=gen,
                                          device="cuda"), iu).bfloat16()
    Ph = packed_outer_products(torch.rand((cells, k), generator=gen,
                                          device="cuda"), iu).bfloat16()
    Pw_v = maskgram.pair_buffer(genes, npairs, "cuda")
    Pw_v.copy_(Pw)
    Ph_v = maskgram.pair_buffer(cells, npairs, "cuda")
    Ph_v.copy_(Ph)
    acc0 = torch.rand((npairs, genes), generator=gen, device="cuda")
    seed = seed_pair(MASKED["mask_seed"])
    hkw = dict(inv_density=MASKED["inv_density"], cells_true=cells_true,
               genes_true=genes_true)
    kw = dict(gene_block=G, **hkw)
    ids64 = torch.arange(cell_offset, cell_offset + cells, device="cuda")
    ids = ids64.to(torch.int32)
    words = pack_mask_words(seed, ids64, genes_pad=genes, gene_block=G,
                            **hkw)
    b = min(block, cells)
    ones = torch.ones((npairs, 1), device="cuda")
    rows = []

    # the hash pass alone, both layouts: the plain version's words
    hash_ms = {}
    for gene_rows in (False, True):
        def hashed(f, gene_rows=gene_rows):
            return f(seed, ids[:b], genes, gene_rows=gene_rows, **hkw)

        if not torch.equal(hashed(maskgram_cuda.pack_mask_k_cuda),
                           hashed(maskgram.pack_mask_k)):
            raise AssertionError(f"hash pass {label} (gene_rows={gene_rows})"
                                 ": differs from the plain version")
        if timed:
            hash_ms["B11" if gene_rows else "B10"] = _median_ms(
                torch, lambda: hashed(maskgram_cuda.pack_mask_k_cuda),
                runs=10)

    def b10(f):
        return f(Pw_v, seed, ids[:b], **kw)

    def b11(f):
        acc = acc0.clone()
        for s in range(0, cells, b):
            f(Ph_v[s:s + b], seed, ids[s:s + b], acc, **kw)
        return acc

    def b8():
        return maskgram_cuda.mask_packed_w_t_bits_cuda(
            Pw_v, ones[:, 0], words[:b], gene_block=G)

    def b9():
        acc = acc0.clone()
        for s in range(0, cells, b):
            maskgram_cuda.mask_packed_h_t_bits_cuda(
                Ph_v[s:s + b], ones, words[s:s + b], acc, gene_block=G,
                scale_block=b)
        return acc

    m = maskgram.hash_mask(seed, ids64[:b], genes, **hkw)
    nnz = int(m.sum())
    m_bf = m.to(torch.bfloat16)
    m_t = m_bf.T.contiguous()
    buf = acc0.clone()
    for name, call, kern, plain, bits_call, one, old, library, bytes_ in (
            ("B10", b10, maskgram_cuda.mask_packed_w_t_cuda,
             maskgram.mask_packed_w_t_plain, b8,
             lambda f: f(Pw_v, seed, ids[:b], **kw),
             lambda: maskgram_cuda.mask_packed_w_t_bits_cuda(
                 Pw_v, ones[:, 0], words[:b], gene_block=G),
             lambda: torch.matmul(Pw.T, m_t),
             genes * npairs * 2 + b * 4 + npairs * b * 4),
            ("B11", b11, maskgram_cuda.mask_packed_h_t_cuda,
             maskgram.mask_packed_h_t_plain, b9,
             lambda f: f(Ph_v[:b], seed, ids[:b], buf, **kw),
             lambda: maskgram_cuda.mask_packed_h_t_bits_cuda(
                 Ph_v[:b], ones, words[:b], buf, gene_block=G,
                 scale_block=b),
             lambda: torch.matmul(Ph[:b].T, m_bf),
             b * npairs * 2 + b * 4 + 2 * npairs * genes * 4)):
        got, again, want = call(kern), call(kern), call(plain)
        err, scale = float((got - want).abs().max()), float(want.abs().max())
        if not err <= 1e-5 * scale:
            raise AssertionError(f"{name} {label}: max abs err {err} > 1e-5 "
                                 f"x {scale}")
        if not torch.equal(got, again):
            raise AssertionError(f"{name} {label}: two runs differ")
        bits_err = float((got - bits_call()).abs().max())
        if not bits_err <= 1e-5 * scale:
            raise AssertionError(f"{name} {label}: differs from bf16 "
                                 f"{'B8' if name == 'B10' else 'B9'} on the "
                                 f"packed words by {bits_err}")
        row = dict(shape=label, kernel=name, cells=cells, block=b, k=k,
                   genes=genes, max_abs_err=err, max_abs_out=scale,
                   err_vs_bits=bits_err)
        times = ""
        if timed:
            turns = {"old": [], "new": []}
            for who in ("old", "new", "new", "old"):
                turns[who].append(_median_ms(
                    torch, old if who == "old" else lambda: one(kern),
                    runs=10))
            row.update(ms=_median_ms(torch, lambda: one(kern), runs=10),
                       hash_ms=hash_ms[name],
                       plain_ms=_median_ms(torch, lambda: one(plain), runs=2),
                       library_ms=_median_ms(torch, library, runs=10),
                       turns_old_ms=turns["old"], turns_new_ms=turns["new"],
                       dense_ms=2 * b * genes * npairs / BF16_OPS_S * 1e3,
                       **_bound(bytes_, 2 * nnz * npairs, BF16_OPS_S))
            times = (f", per call of {b} cells: kernel {row['ms']:.4f} ms "
                     f"(its hash pass {row['hash_ms']:.4f}), plain "
                     f"{row['plain_ms']:.3f} ms, torch.matmul "
                     f"{row['library_ms']:.4f} ms, bound "
                     f"{row['bound_ms']:.4f} ms ({row['bound_by']}), dense "
                     f"product at the bf16 peak {row['dense_ms']:.4f} ms; in "
                     f"turns bf16 {'B8' if name == 'B10' else 'B9'} on the "
                     f"words {[round(t, 4) for t in turns['old']]} ms, "
                     f"{name} {[round(t, 4) for t in turns['new']]} ms")
        rows.append(row)
        print(f"kernel {name} {label} cells={cells} block={b} k={k} "
              f"genes={genes}: max|err|={err:.3e} (max|out| {scale:.3e}), "
              f"same bits twice, against bf16 "
              f"{'B8' if name == 'B10' else 'B9'} {bits_err:.3e}{times} "
              f"({card})", flush=True)
    return rows


def _timed_manager(directory: str, every: int):
    """A CheckpointManager of ``directory`` that records the wall seconds
    of each of its saves (the write of the .npz) in ``save_s``."""
    from singlet_tpu_torch.checkpoint import CheckpointManager

    class TimedManager(CheckpointManager):
        def save(self, it, state):
            t0 = time.perf_counter()
            out = super().save(it, state)
            self.save_s.append(time.perf_counter() - t0)
            return out

    mgr = TimedManager(directory, every=every)
    mgr.save_s = []
    return mgr


def _same(label, got, want, fields):
    """Raise unless ``got`` and ``want`` (fit results, objects or dicts)
    hold the same bits in every one of ``fields``."""
    for f in fields:
        x, y = ((got[f], want[f]) if isinstance(got, dict)
                else (getattr(got, f), getattr(want, f)))
        if not np.array_equal(np.asarray(x), np.asarray(y)):
            raise AssertionError(f"{label}: {f} differs")


def phase_resume_dense(torch, card, Ap, Atp, W0, ckdir):
    """Resumable dense fits at the bench config: ``nmf_fit`` and
    ``ard_nmf_fit`` with a checkpoint every 5 iterations, stopped at 10 and
    resumed to 20, equal bit for bit to an uninterrupted checkpointed and
    an uncheckpointed 20-iteration fit."""
    import singlet_tpu_torch as stt

    k = BENCH["k"]
    out = {}
    for algo, fit, kw, fields, iters_of in (
            ("nmf_fit", stt.nmf_fit, dict(At=Atp, w_init=W0, tol=0.0),
             ("w", "h", "d", "tol_trace"), lambda r: r.n_iter),
            ("ard_nmf_fit", stt.ard_nmf_fit,
             dict(At=Atp, w_init=W0, mask_seed=MASKED["mask_seed"],
                  inv_density=MASKED["inv_density"], tol=0.0,
                  trace_test_mse=1, overfit_threshold=1.0),
             ("w", "h", "d", "test_mse", "iter", "tol", "score_overfit"),
             lambda r: len(r.iter))):
        plain, plain_s, _ = _counted(torch, lambda: fit(Ap, k, maxit=20,
                                                        **kw))
        full_mgr = _timed_manager(os.path.join(ckdir, f"{algo}_full"), 5)
        full, full_s, n_full = _counted(torch, lambda: fit(
            Ap, k, maxit=20, checkpoint=full_mgr, **kw))
        cut = _timed_manager(os.path.join(ckdir, f"{algo}_cut"), 5)
        first, first_s, _ = _counted(torch, lambda: fit(
            Ap, k, maxit=10, checkpoint=cut, **kw))
        res, res_s, n_res = _counted(torch, lambda: fit(
            Ap, k, maxit=20, checkpoint=cut, **kw))
        if (iters_of(first), iters_of(res), iters_of(full)) != (10, 20, 20):
            raise AssertionError(f"{algo}: iterations {iters_of(first)}, "
                                 f"{iters_of(res)}, {iters_of(full)}")
        # the resumed run took the last 10 iterations alone
        key = "B1" if algo == "nmf_fit" else "B2"
        if n_res[key] * 2 != n_full[key] or n_res["plain"]:
            raise AssertionError(f"{algo}: resumed launches {n_res}, full "
                                 f"{n_full}")
        _same(f"{algo} resumed vs uninterrupted", res, full, fields)
        _same(f"{algo} checkpointed vs uncheckpointed", full, plain, fields)
        out[algo] = dict(plain_s=plain_s, full_s=full_s, first_s=first_s,
                         resumed_s=res_s, saves_s=full_mgr.save_s + cut.save_s,
                         launches_full=n_full, launches_resumed=n_res)
        print(f"resumable {algo} bench config k={k}: stopped at 10 "
              f"({first_s:.3f} s), resumed to 20 ({res_s:.3f} s) = the uninterrupted "
              f"checkpointed fit ({full_s:.3f} s) = the uncheckpointed one "
              f"({plain_s:.3f} s), bit for bit; saves "
              f"{[round(s * 1e3, 2) for s in full_mgr.save_s]} ms ({card})",
              flush=True)
    return out


def phase_resume_ell_bench(torch, card, eng, W0, bits_int8, ckdir):
    """The ELL engine's checkpointed ard_fit on the bench operand, on the
    card's default mode, which takes the hash route (a per-step path packs
    no mask): stopped at 2 and resumed to 5, bit for bit the uninterrupted
    checkpointed fit; its test-MSE trace within rtol 1e-3 of the bits
    route's (int8, ``bits_int8``) with the same traced iterations; per step
    a B3, B4, B10 and B11 per block and B2 per block and once over all
    genes."""
    k = BENCH["k"]
    fit_kw = dict(w_init=W0, mask_seed=MASKED["mask_seed"],
                  inv_density=MASKED["inv_density"], tol=0.0,
                  trace_test_mse=1, overfit_threshold=1.0)
    blocks = eng.data.cells_pad // eng.data.cell_block

    def want(steps):
        return _launches(B2=steps * (blocks + 1), B3=steps * blocks,
                         B4=steps * blocks, B10=steps * blocks,
                         B11=steps * blocks)

    fields = ("w", "h", "d", "test_mse", "iter", "tol", "score_overfit")
    full_mgr = _timed_manager(os.path.join(ckdir, "ell_bench_full"), 1)
    full, full_s, n_full = _counted(torch, lambda: eng.ard_fit(
        k, maxit=5, checkpoint=full_mgr, **fit_kw))
    cut = _timed_manager(os.path.join(ckdir, "ell_bench_cut"), 1)
    first, _, n_first = _counted(torch, lambda: eng.ard_fit(
        k, maxit=2, checkpoint=cut, **fit_kw))
    res, res_s, n_res = _counted(torch, lambda: eng.ard_fit(
        k, maxit=5, checkpoint=cut, **fit_kw))
    # SINGLET_TPU_MASK8=1 is read on the bits route alone: the checkpointed
    # fit still takes the hash route, and gives the same bits
    with _env(SINGLET_TPU_MASK8="1"):
        m8, _, n_m8 = _counted(torch, lambda: eng.ard_fit(
            k, maxit=2, checkpoint=_timed_manager(
                os.path.join(ckdir, "ell_bench_mask8"), 1), **fit_kw))
    if (n_full, n_first, n_res, n_m8) != (want(5), want(2), want(3),
                                          want(2)):
        raise AssertionError(f"ELL bench hash route launches {n_full}, "
                             f"{n_first}, {n_res}, under MASK8 {n_m8}; want "
                             f"5, 2, 3 and 2 steps of {want(1)}")
    _same("ELL bench hash route resumed vs uninterrupted", res, full, fields)
    _same("ELL bench checkpointed fit under MASK8=1 vs without", m8, first,
          fields)
    if full.iter != bits_int8["iter"]:
        raise AssertionError(f"ELL bench: the hash route traced {full.iter}, "
                             f"the bits route {bits_int8['iter']}")
    np.testing.assert_allclose(full.test_mse, bits_int8["test_mse"],
                               rtol=1e-3)
    rel = float(np.max(np.abs(np.subtract(full.test_mse,
                                          bits_int8["test_mse"]))
                       / np.abs(bits_int8["test_mse"])))
    print(f"ELL hash route (checkpointed ard_fit, default mode), bench "
          f"operand k={k}, 5 traced iterations: {full_s:.3f} s, stopped at 2 "
          f"and resumed to 5 bit for bit ({res_s:.3f} s for the last 3); "
          f"test mse within {rel:.2e} relative of the bits route (int8; "
          f"rtol 1e-3), iter {full.iter}; launches {n_full}; under "
          f"SINGLET_TPU_MASK8=1 a checkpointed 2-iteration fit on the same "
          f"route, bit for bit the one without ({card})", flush=True)
    return dict(wall_s=full_s, resumed_s=res_s, launches=n_full,
                launches_cut=n_first, launches_resumed=n_res,
                launches_mask8=n_m8,
                test_mse=full.test_mse, iter=full.iter,
                max_rel_vs_bits=rel, saves_s=full_mgr.save_s)


def phase_resume_search(torch, card, A, full, ckdir):
    """``ard_nmf`` on the planted operand (numpy) with its search-state
    checkpoint: stopped by ``max_fits=3``, then resumed; the same rank,
    cv_data and model as the uninterrupted search ``full``."""
    import singlet_tpu_torch as stt

    ck = os.path.join(ckdir, "ard_search")
    kw = dict(k_max=PLANTED["k_max"], verbose=0, seed=1, device="cuda",
              checkpoint=ck)
    cut, cut_s, _ = _counted(torch, lambda: stt.ard_nmf(A, max_fits=3, **kw))
    res, res_s, n = _counted(torch, lambda: stt.ard_nmf(A, **kw))
    if res.k != full.k:
        raise AssertionError(f"resumed ard_nmf chose {res.k}, the "
                             f"uninterrupted search {full.k}")
    _same("resumed ard_nmf model", res, full, ("w", "d", "h"))
    if not res.cv_data.equals(full.cv_data):
        raise AssertionError(f"resumed ard_nmf cv_data:\n{res.cv_data}\n"
                             f"uninterrupted:\n{full.cv_data}")
    print(f"ard_nmf search checkpoint on the planted operand: stopped after "
          f"3 fits ({cut_s:.3f} s, {len(cut.cv_data['k'].unique())} ranks), "
          f"resumed to rank {res.k} ({res_s:.3f} s), cv_data and model equal "
          f"to the uninterrupted search; launches {n} ({card})", flush=True)
    return dict(stopped_s=cut_s, resumed_s=res_s, selected=res.k,
                cv_rows=len(res.cv_data), launches=n)


def phase_ell_vs_dense(torch, card, eng, Ap, Atp, W0):
    """The ELL engine (the bench operand given as scipy) against the dense
    providers (given as numpy) from one W0: 5 plain iterations and a
    5-iteration masked ard_fit, within the fit tolerance."""
    import singlet_tpu_torch as stt

    k = BENCH["k"]
    res_e, secs_e, n_e = _counted(torch, lambda: eng.fit(
        k, w_init=W0, tol=0.0, maxit=5))
    res_d = stt.nmf_fit(Ap, k, At=Atp, w_init=W0, tol=0.0, maxit=5)
    want = _launches(B1=10, B3=5, B4=5)
    if n_e != want:
        raise AssertionError(f"ELL plain fit launches {n_e}, want {want}")
    for f in ("w", "h", "d"):
        np.testing.assert_allclose(res_e[f], getattr(res_d, f),
                                   rtol=FIT_RTOL, atol=FIT_ATOL, err_msg=f)
    np.testing.assert_allclose(res_e["tol_trace"], res_d.tol_trace,
                               rtol=FIT_RTOL, atol=FIT_ATOL)
    fit_kw = dict(w_init=W0, mask_seed=MASKED["mask_seed"],
                  inv_density=MASKED["inv_density"], tol=0.0, maxit=5,
                  trace_test_mse=1, overfit_threshold=1.0)
    # the f32 route, the arithmetic of the dense providers' masked fit
    with _env(SINGLET_TPU_MASKGRAM="xla"):
        r_e, secs_m, n_m = _counted(torch, lambda: eng.ard_fit(k, **fit_kw))
    r_d = stt.ard_nmf_fit(Ap, k, At=Atp, **fit_kw)
    blocks = eng.data.cells_pad // eng.data.cell_block
    want = _launches(B2=5 * (blocks + 1), B3=5 * blocks, B4=5 * blocks)
    if n_m != want:
        raise AssertionError(f"ELL masked fit launches {n_m}, want {want}")
    if r_e.iter != r_d.iter:
        raise AssertionError(f"ELL vs dense masked: iter {r_e.iter} vs "
                             f"{r_d.iter}")
    np.testing.assert_allclose(r_e.test_mse, r_d.test_mse, rtol=FIT_RTOL)
    for f in ("w", "h", "d"):
        np.testing.assert_allclose(getattr(r_e, f), getattr(r_d, f),
                                   rtol=FIT_RTOL, atol=FIT_ATOL, err_msg=f)
    print(f"ELL vs dense, bench operand k={k}: 5 plain iterations in "
          f"{secs_e:.3f} s ({secs_e * 200:.2f} ms/iteration) and a 5-iteration "
          f"masked ard_fit (f32 route) in {secs_m:.3f} s on the ELL engine "
          f"agree with the "
          f"dense providers within rtol={FIT_RTOL} atol={FIT_ATOL}; iter "
          f"{r_e.iter}; test mse {r_e.test_mse} ({card})", flush=True)
    return dict(plain_s=secs_e, plain_launches=n_e, masked_s=secs_m,
                masked_launches=n_m, iter=r_e.iter,
                test_mse_ell=r_e.test_mse, test_mse_dense=r_d.test_mse,
                tol_trace_ell=res_e["tol_trace"],
                tol_trace_dense=res_d.tol_trace)


def phase_bits_vs_f32(torch, card, eng, W0):
    """The ELL engine's bits route (its default on the card), int8 and
    bf16, against its f32 route on the bench operand from one W0: the same
    traced iterations and test-MSE traces within rtol 1e-3; B5-B9 and B2
    launched as the route prescribes, and nothing else. Then each mode
    under SINGLET_TPU_MASK8=1 against the bits route: B12-B14 in place of
    B8/B9, int8 bit for bit, bf16 test MSE within 1e-5 relative."""
    k = BENCH["k"]
    fit_kw = dict(w_init=W0, mask_seed=MASKED["mask_seed"],
                  inv_density=MASKED["inv_density"], tol=0.0, maxit=5,
                  trace_test_mse=1, overfit_threshold=1.0)
    blocks = eng.data.cells_pad // eng.data.cell_block
    with _env(SINGLET_TPU_MASKGRAM="xla"):
        r_f, secs_f, n_f = _counted(torch, lambda: eng.ard_fit(k, **fit_kw))
    if n_f != _launches(B2=5 * (blocks + 1), B3=5 * blocks, B4=5 * blocks):
        raise AssertionError(f"f32 route launches {n_f}")
    out = dict(f32=dict(wall_s=secs_f, test_mse=r_f.test_mse,
                        iter=r_f.iter, launches=n_f))
    for mode in ("int8", "bf16"):
        with _env(SINGLET_TPU_MASKGRAM=mode):
            r_b, secs_b, n_b = _counted(torch,
                                        lambda: eng.ard_fit(k, **fit_kw))
        # F = the 4 blocks: one B9 flush per iteration
        want = _launches(B2=5 * (blocks + 1), B5=5 * blocks, B6=5 * blocks,
                         B7=5, B8=5 * blocks, B9=5, pairs=5 * (blocks + 1))
        if n_b != want:
            raise AssertionError(f"bits route ({mode}) launches {n_b}, want "
                                 f"{want}")
        if r_b.iter != r_f.iter:
            raise AssertionError(f"bits route ({mode}) traced {r_b.iter}, "
                                 f"the f32 route {r_f.iter}")
        np.testing.assert_allclose(r_b.test_mse, r_f.test_mse, rtol=1e-3)
        rel = float(np.max(np.abs(np.subtract(r_b.test_mse, r_f.test_mse))
                           / np.abs(r_f.test_mse)))
        out[mode] = dict(wall_s=secs_b, test_mse=r_b.test_mse,
                         iter=r_b.iter, launches=n_b, max_rel_test_mse=rel)
        print(f"ELL bits route ({mode}) vs f32 route, bench operand k={k}, 5 "
              f"traced iterations: {secs_b:.3f} s against {secs_f:.3f} s; "
              f"iter {r_b.iter}; test mse within {rel:.2e} relative "
              f"(rtol 1e-3); launches {n_b} ({card})", flush=True)

        # the same fit under SINGLET_TPU_MASK8=1: per iteration one B12 and
        # one B14 for the one group of 4 blocks, a B13 per block in place of
        # B8; int8 gives the bits route's bits, bf16 its test MSE within
        # 1e-5 relative
        with _env(SINGLET_TPU_MASKGRAM=mode, SINGLET_TPU_MASK8="1"):
            r_8, secs_8, n_8 = _counted(torch,
                                        lambda: eng.ard_fit(k, **fit_kw))
        want = _launches(B2=5 * (blocks + 1), B5=5 * blocks, B6=5 * blocks,
                         B7=5, B12=5, B13=5 * blocks, B14=5,
                         pairs=5 * (blocks + 1))
        if n_8 != want:
            raise AssertionError(f"MASK8 route ({mode}) launches {n_8}, want "
                                 f"{want}")
        if r_8.iter != r_b.iter:
            raise AssertionError(f"MASK8 route ({mode}) traced {r_8.iter}, "
                                 f"the bits route {r_b.iter}")
        rel8 = float(np.max(np.abs(np.subtract(r_8.test_mse, r_b.test_mse))
                            / np.abs(r_b.test_mse)))
        if mode == "int8":
            _same("MASK8 route vs bits route (int8)", r_8, r_b,
                  ("w", "h", "d", "test_mse", "iter", "tol",
                   "score_overfit"))
        elif not rel8 <= 1e-5:
            raise AssertionError(f"MASK8 route (bf16): test mse {r_8.test_mse}"
                                 f", the bits route {r_b.test_mse}")
        out[mode].update(mask8=dict(wall_s=secs_8, test_mse=r_8.test_mse,
                                    launches=n_8, max_rel_vs_bits=rel8))
        print(f"ELL MASK8 route ({mode}) vs bits route, bench operand k={k}, "
              f"5 traced iterations: {secs_8:.3f} s against {secs_b:.3f} s; "
              f"iter {r_8.iter}; test mse "
              f"{'bit for bit' if mode == 'int8' else f'within {rel8:.2e}'}"
              f" ({'w, h, d too' if mode == 'int8' else 'rtol 1e-5'}); "
              f"launches {n_8} ({card})", flush=True)
    return out


@contextlib.contextmanager
def _kernel_routes_on_cpu():
    """The ELL engine's kernel routes on the CPU, through the plain versions
    of the kernels: its backend test ``_kernel_device`` answers True for the
    block, as tests/test_torch_maskbits_cuda.py forces it."""
    from singlet_tpu_torch.parallel import sharded_ell

    old = sharded_ell._kernel_device
    sharded_ell._kernel_device = lambda device: True
    try:
        yield
    finally:
        sharded_ell._kernel_device = old


def phase_wide_k(torch, card, data):
    """Ranks above 224, on the card against the plain versions and the CPU:
    kernels B1 (n=2048, sweep cap 8) and B2 (n=512, per-column Grams of a
    5% mask, cap 32; its packed entry and its tile entry, the same bits) at
    k=256 and 300, within KERNEL_RTOL/KERNEL_ATOL; B3
    and B4 (unmasked and masked), B5 and B6 (the same bits as masked B3 and
    B4) and B7 on the bench operand's ELL planes ``data`` and its packed
    test mask at the same ranks, B3-B6 within BELL_TOL (B4 and B6 also the
    same bits twice) and B7's sums within rtol 2e-4 with equal counts;
    then ``run_nmf`` at k=256 on a 4096 x 2048 operand, and the
    ELL engine's plain ``fit`` and masked ``ard_fit`` (its default bits
    route) at k=256 on a 768 x 768 operand, each on the card against the
    CPU (the CPU's ``ard_fit`` on the same route through the plain
    versions) within FIT_RTOL/FIT_ATOL, with equal ``iter`` lists. The
    ELL operand has 3 genes and 3 cells per factor: at 256 x 512 a
    cell's kept genes, fewer than k, leave its masked NNLS without a unique
    solution, and bf16 and int8 fits parted by a factor of 2 in test MSE
    on the CPU alone."""
    import scipy.sparse as sp

    import singlet_tpu_torch as stt
    from singlet_tpu_torch.ops import bell, bell_cuda, linalg, nnls
    from singlet_tpu_torch.ops.nnls_cuda import (
        nnls_batch_cuda, nnls_batch_cuda_batched_at,
        nnls_batch_cuda_batched_packed_t)
    from singlet_tpu_torch.ops.rngmask import seed_pair
    from singlet_tpu_torch.parallel.sharded_ell import ShardedEllEngine

    G, li, lv = data.gene_block, data.b_li, data.b_val
    genes, cells = data.genes_pad, data.cells_pad
    words = _slice_words(torch, 0, cells, genes, G,
                         cells_true=data.cells_true,
                         genes_true=data.genes_true)
    seed = seed_pair(MASKED["mask_seed"])
    inv = MASKED["inv_density"]
    rows = []

    def timed(fn):
        """(fn's result, its device time in ms by CUDA events)"""
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        out = fn()
        end.record()
        torch.cuda.synchronize()
        return out, start.elapsed_time(end)

    def record(name, k, err, scale, kern, plain_ms):
        row = dict(kernel=name.split()[0], check=name, k=k, max_abs_err=err,
                   max_abs_out=scale, ms=_median_ms(torch, kern, runs=5),
                   plain_ms=plain_ms)
        rows.append(row)
        print(f"kernel {name} at k={k}: max|err|={err:.3e} (max|out| "
              f"{scale:.3e}), kernel {row['ms']:.3f} ms, plain "
              f"{row['plain_ms']:.3f} ms ({card})", flush=True)

    def close(name, k, got, want, rel=BELL_TOL):
        err, scale = float((got - want).abs().max()), float(want.abs().max())
        if not err <= rel * scale:
            raise AssertionError(f"{name} at k={k}: max abs err {err} > "
                                 f"{rel} x {scale}")
        return err, scale

    for k in WIDE_K:
        # B1 against one shared Gram
        a, B, X0, mask = _nnls_problem(torch, 2048, k, seed=k)
        kw = dict(L1=0.01, L2=0.001, update_mask=mask, sweep_cap=8.0)
        Xk = nnls_batch_cuda(a, B, X0, **kw)
        Xp, plain_ms = timed(lambda: nnls.nnls_batch(a, B, X0, **kw))
        np.testing.assert_allclose(Xk.cpu().numpy(), Xp.cpu().numpy(),
                                   rtol=KERNEL_RTOL, atol=KERNEL_ATOL)
        if not torch.equal(Xk[~mask], X0[~mask]):
            raise AssertionError(f"B1 at k={k}: masked rows differ from X0")
        record("B1", k, float((Xk - Xp).abs().max()), float(Xp.abs().max()),
               lambda: nnls_batch_cuda(a, B, X0, **kw), plain_ms)

        # B2 against per-column Grams: a_full minus the packed Gram of the
        # 5% masked rows, as a masked half-update makes them; the packed
        # entry (the fits' route) and the tile entry
        gen = torch.Generator(device="cuda").manual_seed(k)
        n2, m_rows = 512, 2 * k
        F_ = torch.rand((m_rows, k), generator=gen, device="cuda")
        iu = linalg.triu_pairs(k)
        m = torch.rand((n2, m_rows), generator=gen, device="cuda") < 0.05
        packed_t = linalg.mask_dot_t(linalg.packed_outer_products(F_, iu), m,
                                     1)
        a_full = F_.T @ F_ + 1e-15 * torch.eye(k, device="cuda")
        B2 = torch.where(m, 0.0, torch.rand((n2, m_rows), generator=gen,
                                            device="cuda")) @ F_
        X02 = (torch.rand((n2, k), generator=gen, device="cuda")
               * (torch.rand((n2, k), generator=gen, device="cuda") < 0.5))
        mask2 = torch.rand(n2, generator=gen, device="cuda") >= 0.05
        kw2 = dict(L1=0.01, L2=0.001, update_mask=mask2, sweep_cap=32.0)
        at, Xk, _ = _b2_check(torch, f"k={k}", a_full, packed_t, iu, B2,
                              X02, kw2, plain=False)
        Xp, plain_ms = timed(lambda: nnls.nnls_batch(at.permute(2, 1, 0), B2,
                                                     X02, **kw2))
        np.testing.assert_allclose(Xk.cpu().numpy(), Xp.cpu().numpy(),
                                   rtol=KERNEL_RTOL, atol=KERNEL_ATOL)
        err, scale = float((Xk - Xp).abs().max()), float(Xp.abs().max())
        record("B2", k, err, scale,
               lambda: nnls_batch_cuda_batched_packed_t(
                   a_full, packed_t, iu, B2, X02, **kw2), plain_ms)
        record("B2 tile entry", k, err, scale,
               lambda: nnls_batch_cuda_batched_at(at, B2, X02, **kw2),
               plain_ms)
        del at, m

        # B3 unmasked and masked, B5, B7 on the bench planes
        gen = torch.Generator(device="cuda").manual_seed(k + 1)
        W = torch.rand((genes, k), generator=gen, device="cuda")
        H = torch.rand((cells, k), generator=gen, device="cuda")
        spmm_kw = dict(gene_block=G, inv_density=inv)
        for name, kern, plain in (
                ("B3", lambda: bell_cuda.bell_spmm_cuda(li, lv, W, **spmm_kw),
                 lambda: bell.bell_spmm_plain(li, lv, W, **spmm_kw)),
                ("B3 masked",
                 lambda: bell_cuda.bell_spmm_cuda(li, lv, W, seed, 0,
                                                  **spmm_kw),
                 lambda: bell.bell_spmm_plain(li, lv, W, seed, 0, **spmm_kw)),
                ("B5", lambda: bell_cuda.bell_spmm_bits_cuda(
                    li, lv, W, words, gene_block=G),
                 lambda: bell.bell_spmm_bits_plain(li, lv, W, words,
                                                   gene_block=G))):
            got = kern()
            if name == "B5" and not torch.equal(got, bell_cuda.bell_spmm_cuda(
                    li, lv, W, seed, 0, **spmm_kw)):
                raise AssertionError(f"B5 at k={k}: differs from masked B3")
            want, plain_ms = timed(plain)
            record(name, k, *close(name, k, got, want), kern, plain_ms)

        # B4 unmasked and masked, B6 (the same bits as masked B4): two and
        # three column tiles of 128
        t_kw = dict(spmm_kw, n_gb=data.n_gb)
        for name, kern, plain in (
                ("B4", lambda: bell_cuda.bell_spmm_t_cuda(li, lv, H, **t_kw),
                 lambda: bell.bell_spmm_t_plain(li, lv, H, **t_kw)),
                ("B4 masked",
                 lambda: bell_cuda.bell_spmm_t_cuda(li, lv, H, seed, 0,
                                                    **t_kw),
                 lambda: bell.bell_spmm_t_plain(li, lv, H, seed, 0, **t_kw)),
                ("B6", lambda: bell_cuda.bell_spmm_t_bits_cuda(
                    li, lv, H, words, gene_block=G, n_gb=data.n_gb),
                 lambda: bell.bell_spmm_t_bits_plain(
                     li, lv, H, words, gene_block=G, n_gb=data.n_gb))):
            got = kern()
            if not torch.equal(got, kern()):
                raise AssertionError(f"{name} at k={k}: two runs differ")
            if name == "B6" and not torch.equal(got, bell_cuda.bell_spmm_t_cuda(
                    li, lv, H, seed, 0, **t_kw)):
                raise AssertionError(f"B6 at k={k}: differs from masked B4")
            want, plain_ms = timed(plain)
            record(name, k, *close(name, k, got, want), kern, plain_ms)

        def b7(f):
            return f(li, lv, words, W / k, H, gene_block=G)

        got = b7(bell_cuda.bell_mse_bits_cuda)
        want, plain_ms = timed(lambda: b7(bell.bell_mse_bits_plain))
        np.testing.assert_allclose(got[0].cpu().numpy(), want[0].cpu().numpy(),
                                   rtol=2e-4, atol=1e-5)
        if not torch.equal(got[1], want[1]):
            raise AssertionError(f"B7 at k={k}: counts differ")
        record("B7", k, float((got[0] - want[0]).abs().max()),
               float(want[0].abs().max()),
               lambda: b7(bell_cuda.bell_mse_bits_cuda), plain_ms)

    # run_nmf at k=256, card against CPU, from one w_init
    R = WIDE_RUN_NMF
    rng = np.random.default_rng(3)
    A = np.log1p(rng.poisson(0.3, (R["genes"], R["cells"]))).astype(
        np.float32)
    kw = dict(rank=R["k"], tol=0.0, maxit=R["maxit"],
              w_init=rng.random((R["genes"], R["k"])).astype(np.float32))
    m_gpu, secs, n = _counted(torch, lambda: stt.run_nmf(A, device="cuda",
                                                         **kw))
    if n != _launches(B1=2 * R["maxit"]):
        raise AssertionError(f"run_nmf at k={R['k']}: launches {n}")
    m_cpu = stt.run_nmf(A, device="cpu", **kw)
    for f in ("w", "h", "d"):
        np.testing.assert_allclose(getattr(m_gpu, f), getattr(m_cpu, f),
                                   rtol=FIT_RTOL, atol=FIT_ATOL, err_msg=f)
    print(f"run_nmf {R['genes']}x{R['cells']} k={R['k']} maxit={R['maxit']}: "
          f"{secs:.3f} s on the card, launches {n}; cuda vs cpu within "
          f"rtol={FIT_RTOL} atol={FIT_ATOL} ({card})", flush=True)
    out = dict(kernels=rows, run_nmf=dict(wall_s=secs, launches=n))

    # the ELL engine at k=256: plain fit, masked ard_fit on the bits route
    E = WIDE_ELL
    A = sp.random(E["genes"], E["cells"], density=0.2, random_state=5,
                  format="csc", dtype=np.float32)
    w0 = np.random.default_rng(4).random((E["genes"], E["k"])).astype(
        np.float32)
    geom = dict(cell_block=E["cell_block"], gene_block=E["gene_block"])
    gpu = ShardedEllEngine(A, device="cuda", **geom)
    fit_kw = dict(w_init=w0, tol=0.0, maxit=E["maxit"])
    ard_kw = dict(fit_kw, mask_seed=2, inv_density=10, trace_test_mse=1,
                  overfit_threshold=1.0)
    g_fit, fit_s, n_fit = _counted(torch, lambda: gpu.fit(E["k"], **fit_kw))
    if n_fit != _launches(B1=2 * E["maxit"], B3=E["maxit"], B4=E["maxit"]):
        raise AssertionError(f"ELL fit at k={E['k']}: launches {n_fit}")
    with _kernel_routes_on_cpu():
        c_fit = ShardedEllEngine(A, device="cpu", **geom).fit(E["k"],
                                                              **fit_kw)
    for f in ("w", "h", "d"):
        np.testing.assert_allclose(g_fit[f], c_fit[f], rtol=FIT_RTOL,
                                   atol=FIT_ATOL, err_msg=f"fit {f}")
    out["ell_fit"] = dict(wall_s=fit_s, launches=n_fit)
    print(f"ELL engine at k={E['k']} on a {E['genes']}x{E['cells']} operand: "
          f"plain fit {fit_s:.3f} s, launches {n_fit}; cuda vs cpu within "
          f"rtol={FIT_RTOL} atol={FIT_ATOL} ({card})", flush=True)
    # the masked ard_fit on the default bits route (int8), the CPU's on the
    # same route through the plain versions
    g_ard, ard_s, n_ard = _counted(torch, lambda: gpu.ard_fit(E["k"],
                                                              **ard_kw))
    with _kernel_routes_on_cpu():
        c_ard = ShardedEllEngine(A, device="cpu", **geom).ard_fit(E["k"],
                                                                  **ard_kw)
    if not all(n_ard[key] for key in ("B2", "B5", "B6", "B7", "B8", "B9",
                                      "pairs")) \
            or any(n_ard[key] for key in (
                "B1", "B3", "B4", "plain", "plain_bell", "plain_maskgram",
                "plain_maskbits")):
        raise AssertionError(f"ELL ard_fit at k={E['k']}: launches {n_ard}")
    if g_ard.iter != c_ard.iter:
        raise AssertionError(f"ELL ard_fit at k={E['k']}: iter {g_ard.iter} "
                             f"on the card, {c_ard.iter} on the CPU")
    np.testing.assert_allclose(g_ard.test_mse, c_ard.test_mse, rtol=FIT_RTOL)
    for f in ("w", "h", "d"):
        np.testing.assert_allclose(getattr(g_ard, f), getattr(c_ard, f),
                                   rtol=FIT_RTOL, atol=FIT_ATOL,
                                   err_msg=f"ard_fit {f}")
    out["ell_ard"] = dict(wall_s=ard_s, launches=n_ard,
                          test_mse=g_ard.test_mse,
                          test_mse_cpu=c_ard.test_mse)
    print(f"ELL masked ard_fit at k={E['k']} on the bits route (int8): "
          f"{ard_s:.3f} s, iter {g_ard.iter}, launches {n_ard}; test mse "
          f"{g_ard.test_mse} on the card, {c_ard.test_mse} on the CPU; cuda "
          f"vs cpu within rtol={FIT_RTOL} atol={FIT_ATOL} ({card})",
          flush=True)
    out["k600"] = _wide_k600(torch, card, data, words)
    return out


def _block_operand(genes: int, cells: int, k: int, seed: int,
                   ones: bool = False):
    """A planted block operand (genes x cells float32) and a W init of the
    same blocks: gene g and cell c load on factor g mod k and c mod k
    alone, values U(0.5, 1.5) (with ``ones``, 1.0, and the init the
    planted W itself), so that every half-update's Gram is diagonal and a
    rank-k fit is well posed. A rank-600 fit of noise is
    not: on the CPU alone a 1e-6 relative change of the W init moves 2,005
    entries of w past the fit gate in one iteration (4096 x 2048
    log1p(Poisson(0.3)), 8 sweeps), as the host's and the card's matrix
    products, summed in other orders, did."""
    rng = np.random.default_rng(seed)
    g, c = np.arange(genes), np.arange(cells)

    def draw(n):
        return np.ones(n) if ones else rng.uniform(0.5, 1.5, n)

    Wt = np.zeros((genes, k))
    Wt[g, g % k] = draw(genes)
    Ht = np.zeros((k, cells))
    Ht[c % k, c] = draw(cells)
    w_init = np.zeros((genes, k), np.float32)
    w_init[g, g % k] = draw(genes)
    return (Wt @ Ht).astype(np.float32), w_init


def _wide_k600(torch, card, data, words):
    """Ranks above 512, the wide-k routes: B1 (n=2048) and B2 (n=512,
    per-column Grams of a 5% mask; its packed entry the same bits as its
    tile entry) at k=600 and sweep cap 8, and B7 on the bench planes
    ``data`` and their packed test mask ``words``, each against its plain
    version at the tuned routes' gates, the wide route's launch counted;
    then ``run_nmf`` at k=600 on a planted 4096 x 2048 block operand, the
    card against the CPU within FIT_RTOL/FIT_ATOL, and the ELL engine's masked
    ``ard_fit`` on its default bits route at k=600 against the dense
    masked fit on the card: the same traced iterations and test-MSE
    traces within rtol 1e-3, the gate of the bits route against the f32
    route, and the factors within FIT_RTOL/FIT_ATOL. Both fits run on
    planted block operands (``_block_operand``); the ELL one has 3 genes
    and 3 cells a factor, as WIDE_ELL's at k=256. B1 and B2's packed entry
    also in turns with the warp-a-column kernel (``ab_nnls.run_wide``,
    ``ab_nnls_batched.run_wide``) at their shapes; past k = 2048
    (WIDE_PAST) B1 and both entries of B2 on the staged kernels at more
    threads a column, against their plain versions and in turns with the
    warp-a-column kernel; B7 (its tiles of cells) the bits of the
    warp-a-cell kernel it replaced (csrc/bell_mse_bits_wide_warp.cu) and in
    turns with it (``ab_bell_mse.run_wide``) at k = 600 and, past the last
    k of Wd's rows in registers, at B7_PAST_K and 2560 (Wd's rows
    streamed)."""
    import scipy.sparse as sp

    import singlet_tpu_torch as stt
    from singlet_tpu_torch.ops import bell, bell_cuda, linalg, nnls
    from singlet_tpu_torch.ops.nnls_cuda import (
        nnls_batch_cuda, nnls_batch_cuda_batched_packed_t)
    from singlet_tpu_torch.parallel.sharded_ell import ShardedEllEngine
    from singlet_tpu_torch.solvers.als import make_dense_providers

    k = WIDE600["k"]
    cap = float(WIDE600["sweep_cap"])
    rows = {}

    def timed(fn):
        """(fn's result, its device time in ms by CUDA events)"""
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        out = fn()
        end.record()
        torch.cuda.synchronize()
        return out, start.elapsed_time(end)

    # B1 against one shared Gram
    n1 = WIDE600["b1_n"]
    a, B, X0, mask = _nnls_problem(torch, n1, k, seed=k)
    kw = dict(L1=0.01, L2=0.001, update_mask=mask, sweep_cap=cap)
    Xk, _, n_k = _counted(torch, lambda: nnls_batch_cuda(a, B, X0, **kw))
    if n_k != _launches(B1=1, B1w=1):
        raise AssertionError(f"B1 at k={k}: launches {n_k}")
    (Xp, sweeps), plain_ms = timed(lambda: nnls.nnls_batch(
        a, B, X0, return_sweeps=True, **kw))
    np.testing.assert_allclose(Xk.cpu().numpy(), Xp.cpu().numpy(),
                               rtol=KERNEL_RTOL, atol=KERNEL_ATOL)
    if not torch.equal(Xk[~mask], X0[~mask]):
        raise AssertionError(f"B1 at k={k}: masked rows differ from X0")
    rows["B1"] = dict(kernel="B1", n=n1, k=k, sweep_cap=cap,
                      max_abs_err=float((Xk - Xp).abs().max()),
                      ms=_median_ms(torch, lambda: nnls_batch_cuda(
                          a, B, X0, **kw), runs=5),
                      plain_ms=plain_ms, library_ms=None,
                      **_nnls_bound(sweeps, n1, k, k * k))
    del a, B, X0, Xk, Xp

    # B2 against per-column Grams, as a masked half-update makes them
    gen = torch.Generator(device="cuda").manual_seed(k)
    n2, m_rows = WIDE600["b2_n"], 2 * k
    F_ = torch.rand((m_rows, k), generator=gen, device="cuda")
    iu = linalg.triu_pairs(k)
    m = torch.rand((n2, m_rows), generator=gen, device="cuda") < 0.05
    packed_t = linalg.mask_dot_t(linalg.packed_outer_products(F_, iu), m, 1)
    a_full = F_.T @ F_ + 1e-15 * torch.eye(k, device="cuda")
    B2 = torch.where(m, 0.0, torch.rand((n2, m_rows), generator=gen,
                                        device="cuda")) @ F_
    X02 = (torch.rand((n2, k), generator=gen, device="cuda")
           * (torch.rand((n2, k), generator=gen, device="cuda") < 0.5))
    mask2 = torch.rand(n2, generator=gen, device="cuda") >= 0.05
    kw2 = dict(L1=0.01, L2=0.001, update_mask=mask2, sweep_cap=cap)
    (at, Xk, (Xp, sweeps)), _, n_k = _counted(torch, lambda: _b2_check(
        torch, f"k={k}", a_full, packed_t, iu, B2, X02, kw2))
    if n_k != _launches(B2=2, B2w=2, plain=1):
        raise AssertionError(f"B2 at k={k}: launches {n_k}")
    _, plain_ms = timed(lambda: nnls.nnls_batch(at.permute(2, 1, 0), B2, X02,
                                                **kw2))
    rows["B2"] = dict(kernel="B2", n=n2, k=k, sweep_cap=cap,
                      max_abs_err=float((Xk - Xp).abs().max()),
                      ms=_median_ms(torch, lambda:
                                    nnls_batch_cuda_batched_packed_t(
                                        a_full, packed_t, iu, B2, X02, **kw2),
                                    runs=5),
                      plain_ms=plain_ms, library_ms=None,
                      **_nnls_bound(sweeps, n2, k,
                                    k * k + packed_t.shape[0] * n2))
    del at, m, F_, packed_t, Xk, Xp

    # past k = 2048: B1 on the quad kernel at 64 threads a column, B2 on the
    # staged kernel at 2 columns a block of 64 threads each (both entries),
    # on the ab scripts' inputs (made on the card)
    from singlet_tpu_torch import ab_nnls, ab_nnls_batched
    from singlet_tpu_torch.ops.nnls_cuda import nnls_wide_plan

    kp_ = WIDE_PAST["k"]
    a, B, X0, mask = ab_nnls._problem(torch, n1, kp_, seed=n1 + kp_)
    plan = nnls_wide_plan(n1, kp_, "shared")
    if not plan.depth or plan.lanes <= 32:
        raise AssertionError(f"B1 at k={kp_}: plan {plan}")
    kw = dict(L1=ab_nnls.L1, L2=ab_nnls.L2, update_mask=mask, sweep_cap=cap)
    Xk, _, n_k = _counted(torch, lambda: nnls_batch_cuda(a, B, X0, **kw))
    if n_k != _launches(B1=1, B1w=1):
        raise AssertionError(f"B1 at k={kp_}: launches {n_k}")
    (Xp, sweeps), plain_ms = timed(lambda: nnls.nnls_batch(
        a, B, X0, return_sweeps=True, **kw))
    np.testing.assert_allclose(Xk.cpu().numpy(), Xp.cpu().numpy(),
                               rtol=KERNEL_RTOL, atol=KERNEL_ATOL)
    if not torch.equal(Xk[~mask], X0[~mask]):
        raise AssertionError(f"B1 at k={kp_}: masked rows differ from X0")
    rows["B1 past"] = dict(kernel="B1", n=n1, k=kp_, sweep_cap=cap,
                           launches=n_k, plan=plan._asdict(),
                           max_abs_err=float((Xk - Xp).abs().max()),
                           ms=_median_ms(torch, lambda: nnls_batch_cuda(
                               a, B, X0, **kw), runs=5),
                           plain_ms=plain_ms, library_ms=None,
                           **_nnls_bound(sweeps, n1, kp_, kp_ * kp_))
    del a, B, X0, Xk, Xp
    torch.cuda.empty_cache()
    a_full, packed_t, iu, B2, X02, mask2 = ab_nnls_batched._inputs(
        torch, n2, kp_, seed=n2 + kp_)
    plan = nnls_wide_plan(n2, kp_)
    if not plan.depth or plan.lanes <= 32:
        raise AssertionError(f"B2 at k={kp_}: plan {plan}")
    kw2 = dict(L1=0.01, L2=0.001, update_mask=mask2, sweep_cap=cap)
    (at, Xk, _), _, n_k = _counted(torch, lambda: _b2_check(
        torch, f"k={kp_}", a_full, packed_t, iu, B2, X02, kw2, plain=False))
    if n_k != _launches(B2=2, B2w=2):
        raise AssertionError(f"B2 at k={kp_}: launches {n_k}")
    (Xp, sweeps), plain_ms = timed(lambda: nnls.nnls_batch(
        at.permute(2, 1, 0), B2, X02, return_sweeps=True, **kw2))
    np.testing.assert_allclose(Xk.cpu().numpy(), Xp.cpu().numpy(),
                               rtol=KERNEL_RTOL, atol=KERNEL_ATOL)
    del at
    rows["B2 past"] = dict(kernel="B2", n=n2, k=kp_, sweep_cap=cap,
                           launches=n_k, plan=plan._asdict(),
                           max_abs_err=float((Xk - Xp).abs().max()),
                           ms=_median_ms(torch, lambda:
                                         nnls_batch_cuda_batched_packed_t(
                                             a_full, packed_t, iu, B2, X02,
                                             **kw2), runs=5),
                           plain_ms=plain_ms, library_ms=None,
                           **_nnls_bound(sweeps, n2, kp_,
                                         kp_ * kp_ + packed_t.shape[0] * n2))
    del packed_t, a_full, B2, X02, Xk, Xp
    torch.cuda.empty_cache()

    # B7 on the bench planes: the tiles of cells at k, and past the last k
    # of Wd's rows in registers their streamed form
    from singlet_tpu_torch import ab_bell_mse

    G, li, lv = data.gene_block, data.b_li, data.b_val
    genes, cells = data.genes_pad, data.cells_pad
    warp = ab_bell_mse.warp_kernel()

    def b7_warp(Wd, H):
        """The warp-a-cell kernel kept in csrc/bell_mse_bits_wide_warp.cu,
        on the same inputs."""
        out = torch.full((2, cells), float("nan"), device="cuda")
        err = warp(li.data_ptr(), lv.data_ptr(), li.stride(0), data.n_gb,
                   li.shape[0] // data.n_gb, cells, G, words.data_ptr(),
                   words.stride(0), Wd.data_ptr(), H.data_ptr(), Wd.shape[1],
                   out.data_ptr(), torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"the kept warp-a-cell kernel: {err}")
        return out

    def b7_row(name, k, route, n_want):
        """B7 at rank k on the bench planes: the route's plan, its launches,
        the plain version's gate and counts, the kept kernel's bits."""
        gen = torch.Generator(device="cuda").manual_seed(k + 1)
        Wd = torch.rand((genes, k), generator=gen, device="cuda") / k
        H = torch.rand((cells, k), generator=gen, device="cuda")

        def b7(f):
            return f(li, lv, words, Wd, H, gene_block=G)

        width = li.shape[0] // data.n_gb
        plan = bell_cuda.b7_plan(cells, data.n_gb, G, width, k)
        if not isinstance(plan, route) or (
                plan.npl > 32) != (k > bell_cuda.MAX_K_MSE_WIDE):
            raise AssertionError(f"B7 at k={k}: not the {route.__name__} "
                                 f"({plan})")
        got, _, n_k = _counted(torch, lambda: b7(
            bell_cuda.bell_mse_bits_cuda))
        if n_k != n_want:
            raise AssertionError(f"B7 at k={k}: launches {n_k}")
        want, plain_ms = timed(lambda: b7(bell.bell_mse_bits_plain))
        np.testing.assert_allclose(got[0].cpu().numpy(),
                                   want[0].cpu().numpy(), rtol=2e-4,
                                   atol=1e-5)
        if not torch.equal(got[1], want[1]):
            raise AssertionError(f"B7 at k={k}: counts differ")
        if not torch.equal(got, b7_warp(Wd, H)):
            raise AssertionError(f"B7 at k={k}: not the bits of the kept "
                                 "warp-a-cell kernel")
        held = float(got[1].sum())
        rows[name] = dict(kernel="B7", cells=cells, k=k, launches=n_k,
                          max_abs_err=float((got[0] - want[0]).abs().max()),
                          ms=_median_ms(torch, lambda: b7(
                              bell_cuda.bell_mse_bits_cuda), runs=5),
                          plain_ms=plain_ms, library_ms=None, held_out=held,
                          same_bits_as_warp=True,
                          **_bound(2 * li.numel() * 4 + words.numel() * 4
                                   + (genes + cells) * k * 4 + 2 * cells * 4,
                                   2 * k * held, F32_OPS_S))

    b7_row("B7", k, bell_cuda.B7WidePlan, _launches(B7=1, B7w=1))
    for kk in WIDE_PAST["b7_ks"]:
        b7_row(f"B7 past {kk}", kk, bell_cuda.B7WidePlan,
               _launches(B7=1, B7w=1))
    # B1 and B2's packed entry (past k = 2048 its tile entry too) in turns
    # with the warp-a-column kernel they replaced (csrc/nnls_wide_warp.cu;
    # past k = 2048 nnls_wide.cuh's own, forced), on the ab scripts' inputs
    # at these shapes: the same bits; B7 in turns with the warp-a-cell
    # kernel it replaced (csrc/bell_mse_bits_wide_warp.cu)
    rows["B1"]["turns"], rows["B1 past"]["turns"] = ab_nnls.run_wide(
        torch, shapes=((n1, k), (n1, kp_)), card=card)
    rows["B2"]["turns"] = ab_nnls_batched.run_wide(
        torch, shapes=((n2, k),), card=card)[0]
    rows["B2 past"]["turns"], rows["B2 past"]["turns_tile"] = \
        ab_nnls_batched.run_wide(torch, shapes=((n2, kp_),), card=card)
    b7_turns = ab_bell_mse.run_wide(
        torch, shapes=tuple(("bench", "bench", 0, None, kk, "warp")
                            for kk in (k,) + WIDE_PAST["b7_ks"]),
        card=card, planes=(li, lv, G, data.n_gb))
    rows["B7"]["turns"] = b7_turns[0]
    for kk, t in zip(WIDE_PAST["b7_ks"], b7_turns[1:]):
        rows[f"B7 past {kk}"]["turns"] = t
    for name, r in rows.items():
        print(f"kernel {name} wide-k route at k={r['k']}: max|err|="
              f"{r['max_abs_err']:.3e}, kernel {r['ms']:.3f} ms, plain "
              f"{r['plain_ms']:.3f} ms, bound {r['bound_ms']:.4f} ms "
              f"({r['bound_by']}) ({card})", flush=True)
        for key in ("turns", "turns_tile"):
            if key not in r:
                continue
            t = r[key]
            entry = f" ({t['entry']} entry)" if "entry" in t else ""
            print(f"  {name}{entry} in turns with the kernel it replaced "
                  f"({t['old']}), "
                  f"{WIDE_TURN_NOTE}: {t['new_median_ms']:.4f} ms "
                  f"({t['new_range_ms'][0]:.4f}-{t['new_range_ms'][1]:.4f}) "
                  f"against {t['old_median_ms']:.4f} ms "
                  f"({t['old_range_ms'][0]:.4f}-{t['old_range_ms'][1]:.4f}), "
                  f"the same bits ({card})", flush=True)

    # run_nmf at k=600, card against CPU, from one w_init, on a planted
    # block operand (``_block_operand``: every half-update's Gram diagonal,
    # the fit well posed)
    R = WIDE600_RUN_NMF
    A, w_init = _block_operand(R["genes"], R["cells"], k, seed=6)
    kw = dict(rank=k, tol=0.0, maxit=R["maxit"], w_init=w_init)
    m_gpu, secs, n_run = _counted(torch, lambda: stt.run_nmf(
        A, device="cuda", **kw))
    t0 = time.perf_counter()
    m_cpu = stt.run_nmf(A, device="cpu", **kw)
    cpu_s = time.perf_counter() - t0
    if n_run != _launches(B1=2 * R["maxit"], B1w=2 * R["maxit"]):
        raise AssertionError(f"run_nmf at k={k}: launches {n_run}")
    for f in ("w", "h", "d"):
        np.testing.assert_allclose(getattr(m_gpu, f), getattr(m_cpu, f),
                                   rtol=FIT_RTOL, atol=FIT_ATOL, err_msg=f)
    print(f"run_nmf {R['genes']}x{R['cells']} k={k} maxit={R['maxit']}: "
          f"{secs:.3f} s on the "
          f"card, {cpu_s:.1f} s on the CPU, launches {n_run}; cuda vs cpu "
          f"within rtol={FIT_RTOL} atol={FIT_ATOL} ({card})", flush=True)
    out = dict(kernels=rows, run_nmf=dict(wall_s=secs, cpu_s=cpu_s,
                                          launches=n_run))

    # the ELL engine's bits route at k=600 against the dense masked fit, on
    # a planted block operand of ones started at its W, one iteration:
    # both fits stay on the planted factors, whose packed products every
    # column of the route's int8 quantization holds exactly (at U(0.5,
    # 1.5) values a column's smallest products lose up to 3.5% and the
    # test MSE 1.5%); a second iteration's tol is 0 or not by a rounding,
    # which ends one fit and not the other
    E = WIDE600_ELL
    A, w0 = _block_operand(E["genes"], E["cells"], k, seed=8, ones=True)
    A = sp.csc_matrix(A)
    ard_kw = dict(w_init=w0, mask_seed=2, inv_density=10, tol=0.0,
                  maxit=E["maxit"], trace_test_mse=1, overfit_threshold=1.0)
    eng = ShardedEllEngine(A, device="cuda", cell_block=E["cell_block"],
                           gene_block=E["gene_block"])
    g_ard, ard_s, n_ard = _counted(torch, lambda: eng.ard_fit(k, **ard_kw))
    Ap, Atp = make_dense_providers(A.toarray(), device="cuda")
    d_ard, dense_s, n_dense = _counted(torch, lambda: stt.ard_nmf_fit(
        Ap, k, At=Atp, **ard_kw))
    del eng, Ap, Atp
    if not all(n_ard[key] for key in ("B2", "B5", "B6", "B7", "B8", "B9",
                                      "pairs")) \
            or n_ard["B2w"] != n_ard["B2"] or n_ard["B7w"] != n_ard["B7"] \
            or any(n_ard[key] for key in (
                "B1", "B3", "B4", "plain", "plain_bell", "plain_maskgram",
                "plain_maskbits")):
        raise AssertionError(f"ELL ard_fit at k={k}: launches {n_ard}")
    if n_dense != _launches(B2=n_dense["B2"], B2w=n_dense["B2"]) \
            or not n_dense["B2"]:
        raise AssertionError(f"dense ard_nmf_fit at k={k}: launches "
                             f"{n_dense}")
    if g_ard.iter != d_ard.iter:
        raise AssertionError(f"ELL ard_fit at k={k}: iter {g_ard.iter}, the "
                             f"dense masked fit {d_ard.iter}")
    # the test MSE near 0 where the planted factors predict the held-out
    # entries, else that of the cells whose factor's genes are all held
    # out (their coordinate clamps to 0 on both routes)
    np.testing.assert_allclose(g_ard.test_mse, d_ard.test_mse, rtol=1e-3,
                               atol=1e-9)
    for f in ("w", "h", "d"):
        np.testing.assert_allclose(getattr(g_ard, f), getattr(d_ard, f),
                                   rtol=FIT_RTOL, atol=FIT_ATOL,
                                   err_msg=f"ELL ard_fit at k={k}: {f}")
    rel = float(np.max(np.abs(np.subtract(g_ard.test_mse, d_ard.test_mse))
                       / np.maximum(np.abs(d_ard.test_mse), 1e-30)))
    out["ell_ard"] = dict(wall_s=ard_s, launches=n_ard, dense_s=dense_s,
                          launches_dense=n_dense, test_mse=g_ard.test_mse,
                          test_mse_dense=d_ard.test_mse, max_rel=rel)
    print(f"ELL masked ard_fit at k={k} on the bits route (int8), "
          f"{E['genes']}x{E['cells']}: {ard_s:.3f} s, iter {g_ard.iter}, "
          f"launches {n_ard}; the dense masked fit {dense_s:.3f} s, launches "
          f"{n_dense}; test mse within {rel:.2e} relative (rtol 1e-3) "
          f"({card})", flush=True)
    return out


def _ell_masked_state_gib(genes: int, cells: int, block: int,
                          k: int) -> float:
    """The device state of one bits-route masked step of the ELL engine
    at rank k, GiB, reckoned from ``sharded_ell._masked``: W's packed
    products (float32, and their int8 K-major copy), the w-side carry of
    packed corrections and its rescaled copy (float32, pairs x genes), the
    group operand (int8, up to 16 blocks of H's packed products), and for
    one block its packed corrections and H's packed products (float32)
    with their int8 copy."""
    npairs = k * (k + 1) // 2
    n_blk = cells // block
    group = max(f for f in range(1, min(n_blk, 16) + 1) if n_blk % f == 0)
    per_pair = (4 * genes + genes + 2 * 4 * genes + group * block
                + 2 * 4 * block + block)
    return npairs * per_pair / 2**30


def phase_wide_k600_bench(torch, card, A, Ap, Atp, data):
    """Ranks above 512 at the bench config's size (WIDE600_BENCH, k = 600,
    16,384 genes x 8,192 cells): (a) the dense fit loop ``run_nmf`` runs
    (``nmf_fit`` on the dense providers) for 3 plain iterations from a
    drawn W, ms each, B1-wide's two calls a iteration (8,192 cells, 16,384
    genes) timed by CUDA events inside them; (b) one bits-route masked
    step of the ELL engine on the operand as scipy (``data``), its state
    reckoned and printed first (the cells halved until it fits the card,
    the cut listed), B2-wide's h-side calls (one a 2,048-cell block) and
    its w-side call (all genes) timed apart by CUDA events, after one
    step that builds the lazy buffers, then one test MSE on the step's
    output (the engine's ``_mse``: B7-wide once over all cells), its wall
    time and B7-wide's call by CUDA events; (c) the same calls' shapes in
    turns
    with the warp-a-column kernel (``ab_nnls.run_wide``,
    ``ab_nnls_batched.run_wide``: the same bits, the first 512 columns
    within the B1/B2 gate of the plain version). A fit of noise at k =
    600 is ill posed for card-against-CPU parity (``_block_operand``), so
    (a) and (b) are timed and their outputs checked finite. The
    warp-a-column kernel is ``csrc/nnls_wide_warp.cu``."""
    import scipy.sparse as sp

    import singlet_tpu_torch as stt
    from singlet_tpu_torch import ab_nnls, ab_nnls_batched
    from singlet_tpu_torch.ops import nnls_cuda
    from singlet_tpu_torch.ops.nnls import SweepSettings
    from singlet_tpu_torch.ops.rngmask import seed_pair
    from singlet_tpu_torch.parallel import sharded_ell as tell

    P = WIDE600_BENCH
    k, M = P["k"], P["maxit"]
    g, c = BENCH["genes"], BENCH["cells"]
    rng = np.random.default_rng(P["seed"])
    out = {}

    # (a) the dense fit loop, B1-wide by CUDA events, by n
    W0 = rng.random((g, k), dtype=np.float32)
    with _event_timed(torch, (("nnls_batch_cuda",
                               lambda a, B, *r, **kw: B.shape[0]),),
                      module=nnls_cuda) as ev1:
        res, secs, n_fit = _counted(torch, lambda: stt.nmf_fit(
            Ap, k, At=Atp, w_init=W0, tol=0.0, maxit=M))
    _check_launches(f"run_nmf's fit loop at k={k}", n_fit,
                    _launches(B1=2 * M, B1w=2 * M))
    _check_fit(res.w, res.d, res.h, (g, k), (k, c))
    b1 = {f"n{n}": dict(ms=v[0] / v[1], calls=v[1])
          for n, v in ev1.items()}
    out["run_nmf"] = dict(genes=g, cells=c, k=k, maxit=M, wall_s=secs,
                          ms_per_iter=secs * 1e3 / M, launches=n_fit,
                          b1w=b1, b1w_share=sum(
                              v[0] for v in ev1.values()) / (secs * 1e3))
    print(f"run_nmf's dense fit loop {g}x{c} k={k}: {M} plain iterations "
          f"{secs * 1e3 / M:.1f} ms each; B1-wide by CUDA events "
          + ", ".join(f"n={n} {v[0] / v[1]:.3f} ms a call ({v[1]} calls)"
                      for n, v in sorted(ev1.items()))
          + f", {100 * out['run_nmf']['b1w_share']:.1f}% of the fit's wall "
          f"time ({card})", flush=True)
    del res, W0

    # (b) one bits-route masked step of the ELL engine
    dd, cut = data, None
    while True:
        need = _ell_masked_state_gib(dd.genes_pad, dd.cells_pad,
                                     dd.cell_block, k)
        free = torch.cuda.mem_get_info()[0] / 2**30
        print(f"ELL bits-route masked step at k={k}, {dd.genes_pad} genes x "
              f"{dd.cells_pad} cells: state reckoned {need:.2f} GiB, "
              f"{free:.2f} GiB free ({card})", flush=True)
        if need <= 0.9 * free or dd.cells_pad <= dd.cell_block:
            break
        half = dd.cells_pad // 2
        cut = f"cells halved to {half}: {need:.2f} GiB of state"
        dd = tell.ShardedEllEngine(sp.csc_matrix(A[:, :half]),
                                   device="cuda").data
    fns = tell._build_local_fns(dd, MASKED["inv_density"])
    seed = seed_pair(MASKED["mask_seed"])
    bits = fns["prepare_bits"](seed)
    W = torch.as_tensor(rng.random((dd.genes_pad, k), dtype=np.float32),
                        device="cuda")
    H = torch.as_tensor(rng.random((dd.cells_pad, k), dtype=np.float32),
                        device="cuda")
    fast = float(SweepSettings.from_env().fast_masked)
    blocks = dd.cells_pad // dd.cell_block

    def step():
        return fns["masked"](W, H, seed, 0.01, 0.01, 0.0, 0.0, k,
                             sweep_cap=fast, bits=bits)

    step()   # its lazily built buffers
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    side = (lambda a_full, packed_t, iu, B, *r, **kw:
            "w" if B.shape[0] == dd.genes_pad else "h")
    with _event_timed(torch, (("nnls_batch_cuda_batched_packed_t", side),),
                      module=nnls_cuda) as ev2:
        (W_new, H_new, d_w, tol), step_s, n_step = _counted(torch, step)
    peak = torch.cuda.max_memory_allocated() / 2**30
    _check_launches(f"ELL bits step at k={k}", n_step, _launches(
        B2=blocks + 1, B2w=blocks + 1, B5=blocks, B6=blocks, B8=blocks,
        B9=-(-blocks // 16), pairs=blocks + 1))
    if not all(bool(torch.isfinite(x).all()) for x in (W_new, H_new, d_w)) \
            or not np.isfinite(float(tol)):
        raise AssertionError(f"ELL bits step at k={k}: non-finite output")
    h_ms, w_ms = ev2["h"][0], ev2["w"][0]
    out["ell_step"] = dict(
        genes=dd.genes_pad, cells=dd.cells_pad, k=k, sweep_cap=fast,
        cut=cut, state_gib=need, peak_gib=peak, step_ms=step_s * 1e3,
        launches=n_step, b2w_h_ms=h_ms / ev2["h"][1],
        b2w_h_calls=ev2["h"][1], b2w_w_ms=w_ms,
        b2w_share=(h_ms + w_ms) / (step_s * 1e3))
    o = out["ell_step"]
    print(f"ELL bits-route masked step at k={k} (sweep cap {fast:g}"
          f"{'' if cut is None else '; ' + cut}): {o['step_ms']:.1f} ms, "
          f"peak {peak:.2f} GiB; B2-wide h-side {o['b2w_h_ms']:.3f} ms a "
          f"{dd.cell_block}-cell block ({o['b2w_h_calls']} calls), w-side "
          f"{w_ms:.3f} ms over {dd.genes_pad} genes, "
          f"{100 * o['b2w_share']:.1f}% of the step ({card})", flush=True)

    def mse():
        return fns["mse"](W_new, d_w, H_new, seed, bits=bits)

    mse()   # a first call
    with _event_timed(torch, (("bell_mse_bits_cuda", "B7"),)) as ev3:
        test_mse, mse_s, n_mse = _counted(torch, mse)
    _check_launches(f"ELL test MSE at k={k}", n_mse, _launches(B7=1, B7w=1))
    if not np.isfinite(float(test_mse)):
        raise AssertionError(f"ELL test MSE at k={k}: {float(test_mse)}")
    out["test_mse"] = dict(cells=dd.cells_pad, k=k, ms=mse_s * 1e3,
                           b7w_ms=ev3["B7"][0], launches=n_mse,
                           test_mse=float(test_mse))
    print(f"ELL test MSE at k={k} over {dd.cells_pad} cells: "
          f"{mse_s * 1e3:.3f} ms, B7-wide {ev3['B7'][0]:.3f} ms of it by "
          f"CUDA events, test MSE {float(test_mse):.6g} ({card})",
          flush=True)
    del fns, bits, W, H, W_new, H_new, d_w, dd
    torch.cuda.empty_cache()

    # (c) the same calls' shapes in turns with the warp-a-column kernel
    out["b1_turns"] = ab_nnls.run_wide(torch, shapes=P["b1_turns"],
                                       card=card,
                                       plain_cols=P["plain_cols"])
    out["b2_turns"] = ab_nnls_batched.run_wide(
        torch, shapes=P["b2_turns"], card=card,
        plain_cols=P["plain_cols"])
    for t in out["b1_turns"] + out["b2_turns"]:
        print(f"{t['kernel']} n={t['n']} k={t['k']} cap {t['sweep_cap']:g} "
              f"in turns with the warp-a-column kernel ({t['rounds']} "
              f"rounds of {t['runs']}): {t['new_median_ms']:.3f} ms "
              f"({t['new_range_ms'][0]:.3f}-{t['new_range_ms'][1]:.3f}) "
              f"against {t['old_median_ms']:.3f} ms "
              f"({t['old_range_ms'][0]:.3f}-{t['old_range_ms'][1]:.3f}), "
              f"the same bits, first {t['plain_cols']} columns within the "
              f"gate of the plain version (max|err| "
              f"{t['max_abs_err']:.3e}) ({card})", flush=True)
    torch.cuda.empty_cache()
    return out


def _by_cells(torch, fn, cells: int, step: int, dim: int = 0):
    """fn(cell slice, its first cell) over slices of ``step`` cells,
    concatenated along ``dim``: a plain version whose dense tile of all
    the cells would not fit on the card, slice by slice."""
    return torch.cat([fn(slice(c0, min(c0 + step, cells)), c0)
                      for c0 in range(0, cells, step)], dim=dim)


def _wide_block_turns(torch, card, li, lv, words, csr, nnz):
    """B3 (unmasked) and B5 on the wide-block route in turns with the
    one-warp-per-cell kernel it replaced (``ab_bell_spmm.wide_warp``, the
    same bits) and with torch.sparse.mm on the CSR copy, at each k of
    WIDE_BLOCK's ``turn_ks``: per round new, old, library, library, old,
    new, each turn the median of 10 samples by CUDA events, a sample the
    mean of 5 calls back to back (each side's host work off the card's
    clock, as in a fit); the medians, the spread (every turn) and the
    bound."""
    from singlet_tpu_torch.ab_bell_spmm import wide_warp
    from singlet_tpu_torch.ops import bell_cuda

    P = WIDE_BLOCK
    G, genes, cells = P["gene_block"], P["genes"], P["cells"]
    old = wide_warp(torch)
    rows = []
    for k in P["turn_ks"]:
        W = torch.rand((genes, k), generator=torch.Generator(
            device="cuda").manual_seed(G + k), device="cuda")
        for key, masked in (("B3", False), ("B5", True)):
            if masked:
                def new():
                    return bell_cuda.bell_spmm_bits_cuda(li, lv, W, words,
                                                         gene_block=G)
                args = (2, 0, 0, 1, words)
            else:
                def new():
                    return bell_cuda.bell_spmm_cuda(li, lv, W, gene_block=G)
                args = (0, 0, 0, 1, None)
            mat = csr[masked][0]
            calls = {"new": new,
                     "old": lambda a=args: old(li, lv, W, *a, G),
                     "library": lambda m=mat: torch.sparse.mm(m, W)}
            got = new()
            if not torch.equal(got, calls["old"]()):
                raise AssertionError(f"{key} at gene block {G}, k={k}: the "
                                     "wide-block route differs from the "
                                     "one-warp-per-cell kernel")
            lib_err = float((calls["library"]() - got).abs().max())
            if not lib_err <= BELL_TOL * float(got.abs().max()):
                raise AssertionError(f"{key} k={k}: torch.sparse.mm "
                                     f"differs by {lib_err}")
            turns = {name: [] for name in calls}
            for _ in range(P["rounds"]):
                for name in ("new", "old", "library", "library", "old",
                             "new"):
                    turns[name].append(_median_ms(torch, calls[name],
                                                  runs=10, reps=5))
            med = {name: statistics.median(ts) for name, ts in turns.items()}
            kept = csr[masked][2]
            row = dict(kernel=key, k=k, cells=cells, gene_block=G,
                       plan=bell_cuda.b3_plan(cells, genes // G, G,
                                              li.shape[0] * G // genes, k,
                                              masked)._asdict(),
                       turns_ms=turns, median_ms=med,
                       new_over_old=med["new"] / med["old"],
                       new_over_library=med["new"] / med["library"],
                       **_bound(2 * li.numel() * 4 + (genes + cells) * k * 4
                                + (words.numel() * 4 if masked else 0),
                                2 * kept * k, F32_OPS_S))
            row["bound_share"] = row["bound_ms"] / med["new"]
            rows.append(row)
            print(f"kernel {key} at gene block {G} k={k} ({cells} cells, "
                  f"{kept} kept of {nnz} nonzeros), {P['rounds']} rounds of "
                  f"turns: new {med['new']:.4f} ms "
                  f"({min(turns['new']):.4f}-{max(turns['new']):.4f}), "
                  f"one-warp-per-cell {med['old']:.4f} ms "
                  f"({min(turns['old']):.4f}-{max(turns['old']):.4f}), "
                  f"torch.sparse.mm {med['library']:.4f} ms "
                  f"({min(turns['library']):.4f}-"
                  f"{max(turns['library']):.4f}); new/old "
                  f"{row['new_over_old']:.3f}, new/library "
                  f"{row['new_over_library']:.3f}, bound "
                  f"{row['bound_ms']:.4f} ms ({row['bound_by']}), "
                  f"{100 * row['bound_share']:.1f}% of it; the same bits "
                  f"({card})", flush=True)
        del W
    return rows


def _wide_block_forced(torch, card):
    """At a gene block the tiles take (WIDE_BLOCK's ``tiled_block``), the
    wide-block route forced by the plan gives the tiled kernel's bits, B3
    and B5, at each k of ``turn_ks``."""
    from singlet_tpu_torch.ops import bell_cuda

    P = WIDE_BLOCK
    G, genes, cells = P["tiled_block"], P["genes"], P["cells"]
    li, lv, _ = synth_bell_planes_torch(genes, cells, P["nnz"], G)
    words = _slice_words(torch, 0, cells, genes, G)
    out = {}
    for k in P["turn_ks"]:
        W = torch.rand((genes, k), generator=torch.Generator(
            device="cuda").manual_seed(k), device="cuda")

        def both():
            return (bell_cuda.bell_spmm_cuda(li, lv, W, gene_block=G),
                    bell_cuda.bell_spmm_bits_cuda(li, lv, W, words,
                                                  gene_block=G))

        tiled, (_, _, n_t) = both(), _counted(torch, both)
        saved = bell_cuda.b3_plan
        bell_cuda.b3_plan = lambda c, n_gb, gb, w, kk, bits: \
            bell_cuda.b3_wide_plan(c, kk)
        try:
            wide, _, n_w = _counted(torch, both)
        finally:
            bell_cuda.b3_plan = saved
        if n_t != _launches(B3=1, B5=1) or \
                n_w != _launches(B3=1, B3w=1, B5=1, B5w=1):
            raise AssertionError(f"forced wide plan k={k}: launches "
                                 f"{n_t}, {n_w}")
        for name, t, w in zip(("B3", "B5"), tiled, wide):
            if not torch.equal(t, w):
                raise AssertionError(f"{name} k={k} at gene block {G}: the "
                                     "forced wide-block route differs from "
                                     "the tiles")
        out[k] = True
        print(f"kernels B3 and B5 at gene block {G} ({cells} cells) k={k}: "
              f"the wide-block route forced by the plan gives the tiled "
              f"kernel's bits ({card})", flush=True)
    return out


def phase_wide_block(torch, card):
    """Gene blocks past the tiles of B3 (7,168 genes) and B5 (5,632): the
    large config's 16,384 genes and 824 nonzeros a cell at 4,096 cells, in
    two gene blocks of 8,192. B3 (plain and with the hashed keep) and B5
    on their wide-block route against their plain versions (taken 256
    cells at a time) within BELL_TOL, B5 the bits of masked B3, and B7 on
    its plan against its plain version (rtol 2e-4, equal counts), with
    times, bounds and torch.sparse.mm beside B3 and B5; then the ELL
    engine on these planes against the dense providers from one W0: the
    plain fit (3 iterations) and the masked ``ard_fit`` on the f32 route
    (2, B3 on the wide-block route with the hashed keep) within
    FIT_RTOL/FIT_ATOL, and the default bits route's fit (2, B5 on the
    wide-block route) against the f32 route's test MSE within rtol
    1e-3."""
    import singlet_tpu_torch as stt
    from singlet_tpu_torch.ops import bell, bell_cuda
    from singlet_tpu_torch.ops.rngmask import seed_pair
    from singlet_tpu_torch.parallel.sharded_ell import (ShardedEllData,
                                                        ShardedEllEngine)
    from singlet_tpu_torch.solvers.als import make_dense_providers

    P = WIDE_BLOCK
    genes, cells, G, k = P["genes"], P["cells"], P["gene_block"], P["k"]
    n_gb = genes // G
    li, lv, width = synth_bell_planes_torch(genes, cells, P["nnz"], G)
    nnz = int((li >= 0).sum())
    words = _slice_words(torch, 0, cells, genes, G)
    for bits in (False, True):
        if not isinstance(bell_cuda.b3_plan(cells, n_gb, G, width, k, bits),
                          bell_cuda.B3WidePlan):
            raise AssertionError(f"B{5 if bits else 3} at gene block {G}: "
                                 "the plan does not take the wide-block "
                                 "route")
    b7_wide = not isinstance(bell_cuda.b7_plan(cells, n_gb, G, width, k),
                             bell_cuda.B7Plan)
    gen = torch.Generator(device="cuda").manual_seed(G)
    W = torch.rand((genes, k), generator=gen, device="cuda")
    H = torch.rand((cells, k), generator=gen, device="cuda")
    seed = seed_pair(MASKED["mask_seed"])
    kw = dict(gene_block=G, inv_density=MASKED["inv_density"])
    step = P["plain_cells"]
    csr = {False: _csr_pair(torch, li, lv, G, n_gb),
           True: _csr_pair(torch, li, lv, G, n_gb, words)}
    cases = (
        ("B3", False, lambda: bell_cuda.bell_spmm_cuda(li, lv, W, **kw),
         lambda s, c0: bell.bell_spmm_plain(li[:, s], lv[:, s], W, **kw)),
        ("B3 masked", True,
         lambda: bell_cuda.bell_spmm_cuda(li, lv, W, seed, 0, **kw),
         lambda s, c0: bell.bell_spmm_plain(li[:, s], lv[:, s], W, seed, c0,
                                            **kw)),
        ("B5", True, lambda: bell_cuda.bell_spmm_bits_cuda(
            li, lv, W, words, gene_block=G),
         lambda s, c0: bell.bell_spmm_bits_plain(
             li[:, s], lv[:, s], W, words[s], gene_block=G)))
    rows, out = {}, {}
    for name, masked, kern, plain in cases:
        key = name.split()[0]
        got, _, n_k = _counted(torch, kern)
        want_n = (_launches(B5=1, B5w=1) if key == "B5"
                  else _launches(B3=1, B3w=1))
        if n_k != want_n:
            raise AssertionError(f"{name} at gene block {G}: launches {n_k}")
        if not torch.equal(got, kern()):
            raise AssertionError(f"{name} at gene block {G}: two runs differ")
        t0 = time.perf_counter()
        want = _by_cells(torch, plain, cells, step)
        torch.cuda.synchronize()
        plain_ms = (time.perf_counter() - t0) * 1e3
        err, scale = float((got - want).abs().max()), float(want.abs().max())
        if not err <= BELL_TOL * scale:
            raise AssertionError(f"{name} at gene block {G}: max abs err "
                                 f"{err} > {BELL_TOL} x {scale}")
        if key == "B5":
            out["B5_equals_masked_B3"] = bool(torch.equal(
                got, bell_cuda.bell_spmm_cuda(li, lv, W, seed, 0, **kw)))
            if not out["B5_equals_masked_B3"]:
                raise AssertionError(f"B5 at gene block {G}: differs from "
                                     "masked B3")
        library_ms, lib_nnz, lib_err, _ = _spmm_library(torch, csr[masked],
                                                        key, W, got)
        if not lib_err <= BELL_TOL * scale:
            raise AssertionError(f"{name} at gene block {G}: the library "
                                 f"call differs by {lib_err}")
        rows[name] = dict(kernel=key, masked=masked, cells=cells, k=k,
                          width=width, gene_block=G, max_abs_err=err,
                          max_abs_out=scale,
                          ms=_median_ms(torch, kern, runs=5),
                          plain_ms=plain_ms, library_ms=library_ms,
                          **_bound(2 * li.numel() * 4 + (genes + cells) * k * 4
                                   + (words.numel() * 4 if key == "B5" else 0),
                                   2 * nnz * k, F32_OPS_S))
    Wd = W / k
    got, _, n_k = _counted(torch, lambda: bell_cuda.bell_mse_bits_cuda(
        li, lv, words, Wd, H, gene_block=G))
    if n_k != _launches(B7=1, B7w=int(b7_wide)):
        raise AssertionError(f"B7 at gene block {G}: launches {n_k}")
    t0 = time.perf_counter()
    want = bell.bell_mse_bits_plain(li, lv, words, Wd, H, gene_block=G)
    torch.cuda.synchronize()
    plain_ms = (time.perf_counter() - t0) * 1e3
    np.testing.assert_allclose(got[0].cpu().numpy(), want[0].cpu().numpy(),
                               rtol=2e-4, atol=1e-5)
    if not torch.equal(got[1], want[1]):
        raise AssertionError(f"B7 at gene block {G}: counts differ")
    held = float(got[1].sum())
    rows["B7"] = dict(kernel="B7", cells=cells, k=k, width=width,
                      gene_block=G, wide=bool(b7_wide),
                      max_abs_err=float((got[0] - want[0]).abs().max()),
                      ms=_median_ms(torch, lambda: bell_cuda.bell_mse_bits_cuda(
                          li, lv, words, Wd, H, gene_block=G), runs=5),
                      plain_ms=plain_ms, library_ms=None, held_out=held,
                      **_bound(2 * li.numel() * 4 + words.numel() * 4
                               + (genes + cells) * k * 4 + 2 * cells * 4,
                               2 * k * held, F32_OPS_S))
    # B7's wide route on these planes, where a cell's 416 slots of a gene
    # block pass a thread's registers (10 * 512 / 32): at k = 600 the plan
    # takes it, against the plain version and the bits of the warp-a-cell
    # kernel it replaced; then in turns with that kernel there and, forced
    # at k = 50 and 100, with it and with the tiled kernel the plan takes
    from singlet_tpu_torch import ab_bell_mse

    kw_ = WIDE_BLOCK["b7_k"]
    plan = bell_cuda.b7_plan(cells, n_gb, G, width, kw_)
    if not (isinstance(plan, bell_cuda.B7WidePlan)
            and width > 10 * 512 // plan.cells):
        raise AssertionError(f"B7 at gene block {G}, k={kw_}: plan {plan}")
    gen = torch.Generator(device="cuda").manual_seed(kw_ + 1)
    Wd7 = torch.rand((genes, kw_), generator=gen, device="cuda") / kw_
    H7 = torch.rand((cells, kw_), generator=gen, device="cuda")
    got, _, n_k = _counted(torch, lambda: bell_cuda.bell_mse_bits_cuda(
        li, lv, words, Wd7, H7, gene_block=G))
    if n_k != _launches(B7=1, B7w=1):
        raise AssertionError(f"B7 at gene block {G}, k={kw_}: launches "
                             f"{n_k}")
    t0 = time.perf_counter()
    want = bell.bell_mse_bits_plain(li, lv, words, Wd7, H7, gene_block=G)
    torch.cuda.synchronize()
    plain_ms = (time.perf_counter() - t0) * 1e3
    np.testing.assert_allclose(got[0].cpu().numpy(), want[0].cpu().numpy(),
                               rtol=2e-4, atol=1e-5)
    if not torch.equal(got[1], want[1]):
        raise AssertionError(f"B7 at gene block {G}, k={kw_}: counts differ")
    old = torch.full_like(got, float("nan"))
    if ab_bell_mse.warp_kernel()(
            li.data_ptr(), lv.data_ptr(), li.stride(0), n_gb, width, cells,
            G, words.data_ptr(), words.stride(0), Wd7.data_ptr(),
            H7.data_ptr(), kw_, old.data_ptr(),
            torch.cuda.current_stream().cuda_stream):
        raise RuntimeError("the kept warp-a-cell kernel failed")
    torch.cuda.synchronize()
    if not torch.equal(got, old):
        raise AssertionError(f"B7 at gene block {G}, k={kw_}: not the bits "
                             "of the warp-a-cell kernel")
    held = float(got[1].sum())
    rows["B7 passes"] = dict(
        kernel="B7", cells=cells, k=kw_, width=width, gene_block=G,
        wide=True, launches=n_k, plan=plan._asdict(),
        same_bits_as_warp=True,
        max_abs_err=float((got[0] - want[0]).abs().max()),
        ms=_median_ms(torch, lambda: bell_cuda.bell_mse_bits_cuda(
            li, lv, words, Wd7, H7, gene_block=G), runs=5),
        plain_ms=plain_ms, library_ms=None, held_out=held,
        **_bound(2 * li.numel() * 4 + words.numel() * 4
                 + (genes + cells) * kw_ * 4 + 2 * cells * 4,
                 2 * kw_ * held, F32_OPS_S))
    del Wd7, H7, got, want, old
    rows["B7 passes"]["turns"] = ab_bell_mse.run_wide(
        torch, shapes=tuple(("wide block", "bench", 0, None, kk, against)
                            for kk in P["turn_ks"]
                            for against in ("warp", "tiled"))
        + (("wide block", "bench", 0, None, kw_, "warp"),),
        card=card, planes=(li, lv, G, n_gb))
    for t in rows["B7 passes"]["turns"]:
        print(f"  B7 wide route at gene block {G} (width {width}), k="
              f"{t['k']}{' (forced)' if t['k'] <= 512 else ''}, in turns "
              f"with {t['old']}, {WIDE_TURN_NOTE}: "
              f"{t['new_median_ms']:.4f} ms ({t['new_range_ms'][0]:.4f}-"
              f"{t['new_range_ms'][1]:.4f}) against "
              f"{t['old_median_ms']:.4f} ms ({t['old_range_ms'][0]:.4f}-"
              f"{t['old_range_ms'][1]:.4f}), the same bits ({card})",
              flush=True)
    for name, r in rows.items():
        lib = ("" if r["library_ms"] is None
               else f", torch.sparse.mm {r['library_ms']:.3f} ms")
        print(f"kernel {name} at gene block {G} ({cells} cells, width "
              f"{width}, k={r['k']}): max|err|={r['max_abs_err']:.3e}, kernel "
              f"{r['ms']:.3f} ms, plain {r['plain_ms']:.1f} ms (by slices "
              f"of {step} cells for B3/B5){lib}, bound "
              f"{r['bound_ms']:.4f} ms ({card})", flush=True)
    del W, H, Wd
    out["turns"] = _wide_block_turns(torch, card, li, lv, words, csr, nnz)
    del csr
    out["forced_wide"] = _wide_block_forced(torch, card)

    # the engine on these planes against the dense providers
    data = ShardedEllData(
        b_li=li, b_val=lv, b_width=width,
        nonempty=torch.ones(cells, dtype=torch.bool, device="cuda"),
        gene_nonempty=torch.ones(genes, dtype=torch.bool, device="cuda"),
        device=torch.device("cuda"), genes_true=genes, cells_true=cells,
        genes_pad=genes, cells_pad=cells, cell_block=P["cell_block"],
        gene_block=G)
    eng = ShardedEllEngine(None, data=data)
    A = bell.densify_planes(li, lv, G, n_gb).T.cpu().numpy()
    Ap, Atp = make_dense_providers(A, device="cuda")
    del A
    W0 = np.random.default_rng(9).random((genes, k)).astype(np.float32)
    M = P["maxit"]
    res_e, secs_e, n_e = _counted(torch, lambda: eng.fit(
        k, w_init=W0, tol=0.0, maxit=M))
    if n_e != _launches(B1=2 * M, B3=M, B3w=M, B4=M):
        raise AssertionError(f"wide-block plain fit: launches {n_e}")
    res_d = stt.nmf_fit(Ap, k, At=Atp, w_init=W0, tol=0.0, maxit=M)
    for f in ("w", "h", "d"):
        np.testing.assert_allclose(res_e[f], getattr(res_d, f),
                                   rtol=FIT_RTOL, atol=FIT_ATOL, err_msg=f)
    blocks = cells // P["cell_block"]
    Mm = P["masked_maxit"]
    fit_kw = dict(w_init=W0, mask_seed=MASKED["mask_seed"],
                  inv_density=MASKED["inv_density"], tol=0.0, maxit=Mm,
                  trace_test_mse=1, overfit_threshold=1.0)
    with _env(SINGLET_TPU_MASKGRAM="xla"):
        r_f, secs_f, n_f = _counted(torch, lambda: eng.ard_fit(k, **fit_kw))
    if n_f != _launches(B2=Mm * (blocks + 1), B3=Mm * blocks,
                        B3w=Mm * blocks, B4=Mm * blocks):
        raise AssertionError(f"wide-block f32 masked fit: launches {n_f}")
    r_d = stt.ard_nmf_fit(Ap, k, At=Atp, **fit_kw)
    if r_f.iter != r_d.iter:
        raise AssertionError(f"wide-block masked fit: iter {r_f.iter} vs "
                             f"{r_d.iter}")
    np.testing.assert_allclose(r_f.test_mse, r_d.test_mse, rtol=FIT_RTOL)
    for f in ("w", "h", "d"):
        np.testing.assert_allclose(getattr(r_f, f), getattr(r_d, f),
                                   rtol=FIT_RTOL, atol=FIT_ATOL,
                                   err_msg=f"masked {f}")
    r_b, secs_b, n_b = _counted(torch, lambda: eng.ard_fit(k, **fit_kw))
    want = _launches(B2=Mm * (blocks + 1), B5=Mm * blocks,
                     B5w=Mm * blocks, B6=Mm * blocks, B7=Mm,
                     B7w=Mm * int(b7_wide), B8=Mm * blocks, B9=Mm,
                     pairs=Mm * (blocks + 1))
    if n_b != want:
        raise AssertionError(f"wide-block bits-route fit: launches {n_b}, "
                             f"want {want}")
    if r_b.iter != r_f.iter:
        raise AssertionError(f"wide-block bits route: iter {r_b.iter}, the "
                             f"f32 route {r_f.iter}")
    np.testing.assert_allclose(r_b.test_mse, r_f.test_mse, rtol=1e-3)
    rel = float(np.max(np.abs(np.subtract(r_b.test_mse, r_f.test_mse))
                       / np.abs(r_f.test_mse)))
    print(f"ELL engine at gene block {G} ({genes}x{cells}, k={k}): plain fit "
          f"{M} iterations {secs_e:.3f} s, launches {n_e}; f32-route masked "
          f"fit {secs_f:.3f} s, launches {n_f}; both within rtol={FIT_RTOL} "
          f"atol={FIT_ATOL} of the dense providers; bits-route fit "
          f"{secs_b:.3f} s, launches {n_b}, test mse within {rel:.2e} of the "
          f"f32 route's (rtol 1e-3) ({card})", flush=True)
    out.update(kernels=rows, plain=dict(wall_s=secs_e, launches=n_e),
               f32=dict(wall_s=secs_f, launches=n_f,
                        test_mse=r_f.test_mse),
               bits=dict(wall_s=secs_b, launches=n_b, test_mse=r_b.test_mse,
                         max_rel=rel))
    return out


@contextlib.contextmanager
def _stage_clock(torch, stages):
    """The pipeline's stages timed from outside, each up to a device sync,
    into ``stages`` (seconds by name): ``load_any`` (read),
    ``Experiment.preprocess_data`` (normalize), ``Experiment.run_nmf``
    (nmf), ``Experiment.annotate_nmf`` (annotate) and ``NMFModel.save``
    (save); restored after the block."""
    import singlet_tpu_torch.pipeline as pipe
    from singlet_tpu_torch.experiment import Experiment
    from singlet_tpu_torch.model import NMFModel

    targets = ((pipe, "load_any", "read"),
               (Experiment, "preprocess_data", "normalize"),
               (Experiment, "run_nmf", "nmf"),
               (Experiment, "annotate_nmf", "annotate"),
               (NMFModel, "save", "save"))
    saved = [(owner, attr, getattr(owner, attr)) for owner, attr, _ in
             targets]

    def clocked(fn, name):
        def run(*args, **kwargs):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            try:
                return fn(*args, **kwargs)
            finally:
                torch.cuda.synchronize()
                stages[name] = stages.get(name, 0.0) + time.perf_counter() - t0
        return run

    for (owner, attr, fn), (_, _, name) in zip(saved, targets):
        setattr(owner, attr, clocked(fn, name))
    try:
        yield stages
    finally:
        for owner, attr, fn in saved:
            setattr(owner, attr, fn)


def phase_pipeline(torch, card, root):
    """The front end a user runs: a 10x directory of the large config's
    width (16,384 genes x 8,192 cells, 824 requested nonzeros a cell, raw
    counts 1 + Poisson(0.6), made as phase 15's chunks are) written under
    ``root``; ``cellxgene_pipeline`` on it in this process with k=10 and
    with k=[5, 10, 15] (reps=1), each stage timed (read, normalize, NMF,
    annotate, save); each model bit for bit what
    ``Experiment.from_dataset(read_10x_mtx(dir)).preprocess_data()
    .run_nmf(...)`` gives on the card from the same seed; B1 launched (B2
    too for the list) and no plain version; the .npz, .json and
    .summary.json written. Then ``annotate_nmf`` with synthetic categorical
    metadata and ``run_gsea`` with a small gene-set dict on the k=10
    model (each cell's group that of its largest factor), each timed."""
    import scipy.io

    import singlet_tpu_torch as stt
    import singlet_tpu_torch.pipeline as pipe
    from singlet_tpu_torch.data import read_10x_mtx
    from singlet_tpu_torch.experiment import Experiment

    P = PIPELINE
    genes, cells = P["genes"], P["cells"]
    tenx = os.path.join(root, "tenx")
    os.makedirs(tenx)
    t0 = time.perf_counter()
    M = _stream_chunk(P["seed"], genes, cells, P["nnz"])
    scipy.io.mmwrite(os.path.join(tenx, "matrix.mtx"), M)
    gene_names = [f"GENE{i}" for i in range(genes)]
    with open(os.path.join(tenx, "features.tsv"), "w") as f:
        f.writelines(f"ENSG{i:08d}\t{g}\tGene Expression\n"
                     for i, g in enumerate(gene_names))
    with open(os.path.join(tenx, "barcodes.tsv"), "w") as f:
        f.writelines(f"CELL{i}-1\n" for i in range(cells))
    write_s = time.perf_counter() - t0
    nnz = M.nnz
    del M
    print(f"pipeline input: a 10x directory of {genes} genes x {cells} "
          f"cells, {nnz} nonzeros, written in {write_s:.2f} s ({card})",
          flush=True)
    out = dict(write_s=write_s, nnz=nnz)
    for label, k in (("k10", P["k"]), ("k_list", list(P["ks"]))):
        stem = os.path.join(root, label)
        stages = {}
        with _stage_clock(torch, stages):
            model, secs, n = _counted(torch, lambda: pipe.cellxgene_pipeline(
                tenx, out=stem, k=k, reps=1, verbose=0, device="cuda"))
        for suffix in (".npz", ".json", ".summary.json"):
            if not os.path.isfile(stem + suffix):
                raise AssertionError(f"pipeline {label}: no {stem}{suffix}")
        if not n["B1"] or (label == "k_list" and not n["B2"]) or any(
                n[key] for key in ("plain", "plain_bell", "plain_maskgram",
                                   "plain_maskbits")):
            raise AssertionError(f"pipeline {label}: launches {n}")
        direct = Experiment.from_dataset(read_10x_mtx(tenx)) \
            .preprocess_data().run_nmf(k=k, reps=1, L1=0.05, verbose=0,
                                       seed=0, device="cuda") \
            .reductions["nmf"]
        for f in ("w", "d", "h"):
            if not np.array_equal(getattr(model, f), getattr(direct, f)):
                raise AssertionError(f"pipeline {label}: {f} differs from "
                                     "the direct Experiment fit")
        summary = json.loads(open(stem + ".summary.json").read())
        out[label] = dict(wall_s=secs, stages_s=stages, launches=n,
                          k=model.k, summary=summary)
        print(f"pipeline {label} (k={k}): {secs:.2f} s in all; read "
              f"{stages['read']:.2f} s, normalize {stages['normalize']:.2f} "
              f"s, NMF {stages['nmf']:.2f} s, annotate "
              f"{stages['annotate']:.3f} s, save {stages['save']:.3f} s; "
              f"rank {model.k}; launches {n}; the model bit for bit the "
              f"direct Experiment fit ({card})", flush=True)
        if label == "k10":
            model10 = model
    # categorical metadata tied to the model: a cell's group is that of its
    # largest factor (mod the groups), so that associations exist to find
    labels = np.array([f"group{i % P['groups']}"
                       for i in np.argmax(model10.h, axis=0)], dtype=object)
    t0 = time.perf_counter()
    ann = stt.annotate_nmf(model10, {"group": labels})
    ann_s = time.perf_counter() - t0
    frame = ann["group"]
    if set(frame.columns) != {"group", "factor", "fc", "p"} or \
            not len(frame) or \
            not np.isfinite(frame["p"].to_numpy(float)).all():
        raise AssertionError(f"annotate_nmf: {frame.shape} "
                             f"{list(frame.columns)}")
    order = np.argsort(-model10.w[:, 0])
    sets = {"TOP_NMF_1": [gene_names[i] for i in order[:40]],
            "EVERY_50TH": gene_names[::50][:60],
            "MIDDLE": [gene_names[i] for i in order[4000:4050]]}
    t0 = time.perf_counter()
    gsea = stt.run_gsea(model10, sets, min_size=10, max_size=500, seed=1)
    gsea_s = time.perf_counter() - t0
    if set(gsea) != {"pval", "padj", "es", "nes"} or \
            gsea["padj"].shape != (len(sets), model10.k):
        raise AssertionError(f"run_gsea: {sorted(gsea)} "
                             f"{gsea['padj'].shape}")
    out.update(annotate_s=ann_s, gsea_s=gsea_s)
    print(f"annotate_nmf on the k=10 model with {P['groups']} groups: "
          f"{ann_s:.3f} s; run_gsea with 3 gene sets: {gsea_s:.3f} s "
          f"(host) ({card})", flush=True)
    return out


def phase_large(torch, card, ckdir):
    """The largescale.py operand generated on the card; the plain ELL fit,
    project, one profiled plain step, the masked ard_fit on the f32 and the
    bits route, the resumable masked fit on the hash route; and the kernel
    checks of B3-B11 on a slice of its planes."""
    from singlet_tpu_torch.ops import maskgram_cuda
    from singlet_tpu_torch.ops.nnls import SweepSettings
    from singlet_tpu_torch.ops.rngmask import seed_pair
    from singlet_tpu_torch.parallel.sharded_ell import (ShardedEllData,
                                                        ShardedEllEngine,
                                                        _build_local_fns)

    L = LARGE
    genes, cells, k = L["genes"], L["cells"], L["k"]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    li, lv, width = synth_bell_planes_torch(genes, cells, L["nnz"],
                                            L["gene_block"])
    torch.cuda.synchronize()
    gen_s = time.perf_counter() - t0
    planes_gib = 2 * li.numel() * 4 / 2**30
    nnz = int((li >= 0).sum())
    print(f"large operand {genes} genes x {cells} cells, {nnz} nonzeros "
          f"({nnz / cells:.0f} per cell), width {width}: planes "
          f"{planes_gib:.2f} GiB generated on the card in {gen_s:.3f} s "
          f"({card})", flush=True)
    # every cell holds nonzeros in every gene block, and every gene is
    # counted live, as benchmarks/largescale.py builds it
    data = ShardedEllData(
        b_li=li, b_val=lv, b_width=width,
        nonempty=torch.ones(cells, dtype=torch.bool, device="cuda"),
        gene_nonempty=torch.ones(genes, dtype=torch.bool, device="cuda"),
        device=torch.device("cuda"), genes_true=genes, cells_true=cells,
        genes_pad=genes, cells_pad=cells, cell_block=L["cell_block"],
        gene_block=L["gene_block"])
    eng = ShardedEllEngine(None, data=data)

    c0, n = LARGE_SLICE
    sl_li, sl_lv = li[:, c0:c0 + n], lv[:, c0:c0 + n]
    kernel_rows = phase_bell_kernels(torch, card, "large slice", sl_li,
                                     sl_lv, k, L["gene_block"], data.n_gb,
                                     c0)
    bits_rows = phase_bits_kernels(torch, card, "large slice", sl_li, sl_lv,
                                   k, L["gene_block"], data.n_gb, c0,
                                   block=L["cell_block"])
    hash_rows = phase_hash_kernels(torch, card, "large slice", k, genes,
                                   L["gene_block"], c0, n,
                                   block=L["cell_block"])

    torch.cuda.reset_peak_memory_stats()
    res, secs, n_fit = _counted(torch, lambda: eng.fit(
        k, tol=0.0, maxit=L["maxit"], seed=0))
    iters = len(res["tol_trace"])
    want = _launches(B1=2 * iters, B3=iters, B4=iters)
    if iters != L["maxit"] or n_fit != want:
        raise AssertionError(f"large plain fit: {iters} iterations, "
                             f"launches {n_fit}; want {want}")
    _check_fit(res["w"], res["d"], res["h"], (genes, k), (k, cells))
    if not res["tol_trace"][-1] < res["tol_trace"][0]:
        raise AssertionError(f"large plain fit: tol {res['tol_trace']}")
    ms_it = secs * 1e3 / iters
    peak = torch.cuda.max_memory_allocated() / 2**30
    print(f"large plain ELL fit k={k} maxit={iters} tol=0: {secs:.3f} s, "
          f"{ms_it:.2f} ms/iteration, {cells * 1e3 / ms_it:.0f} cells/s, "
          f"final tol {res['tol_trace'][-1]:.3e}, launches {n_fit}, peak "
          f"{peak:.2f} GiB ({card})", flush=True)
    (h, d), proj_s, n_proj = _counted(torch, lambda: eng.project(res["w"]))
    if h.shape != (k, cells) or not np.isfinite(h).all() or (h < 0).any() \
            or n_proj != _launches(B1=1, B3=1):
        raise AssertionError(f"project: h {h.shape}, launches {n_proj}")
    print(f"large project of {cells} cells: {proj_s:.3f} s, launches "
          f"{n_proj} ({card})", flush=True)
    # one plain step at the fast-phase cap, without the fit's set-up and
    # the copy of h (k x cells) to the host that ends every fit
    fns = _build_local_fns(data, MASKED["inv_density"])
    settings = SweepSettings.from_env()
    W = torch.as_tensor(res["w"], device="cuda")
    H = torch.as_tensor(res["h"].T.copy(), device="cuda")
    profile = _profile(torch, card, lambda: fns["plain"](
        W, H, 0.01, 0.01, 0.0, 0.0, sweep_cap=float(settings.fast)),
        label=f"large plain ELL step (sweep cap {settings.fast})",
        share=(("bell_spmm_kernel", "B3"), ("nnls_cd_kernel", "B1"),
               ("bell_spmm_t_kernel", "B4")),
        events=(("bell_spmm_cuda", "B3"),))

    seed = seed_pair(MASKED["mask_seed"])
    blocks = cells // L["cell_block"]
    ard_kw = dict(tol=0.0, trace_test_mse=1, overfit_threshold=1.0,
                  mask_seed=MASKED["mask_seed"],
                  inv_density=MASKED["inv_density"])

    def masked_fit(label, maxit, want_of):
        torch.cuda.reset_peak_memory_stats()
        r, msecs, n_m = _counted(torch, lambda: eng.ard_fit(
            k, maxit=maxit, **ard_kw))
        steps = len(r.iter)
        if steps != maxit or n_m != want_of(steps):
            raise AssertionError(f"large masked fit ({label}): {steps} "
                                 f"steps, launches {n_m}; want "
                                 f"{want_of(steps)}")
        if not (np.isfinite(r.test_mse).all() and min(r.test_mse) > 0):
            raise AssertionError(f"large masked fit ({label}): test mse "
                                 f"{r.test_mse}")
        _check_fit(r.w, r.d, r.h, (genes, k), (k, cells))
        mpeak = torch.cuda.max_memory_allocated() / 2**30
        print(f"large masked ELL ard_fit ({label}) k={k} {steps} "
              f"iterations, each traced: {msecs:.3f} s, "
              f"{msecs * 1e3 / steps:.1f} ms per masked iteration with its "
              f"test MSE, launches {n_m}, test mse {r.test_mse}, peak "
              f"{mpeak:.2f} GiB ({card})", flush=True)
        out = dict(steps=steps, wall_s=msecs, ms_per_iter=msecs * 1e3 / steps,
                   launches=n_m, test_mse=r.test_mse, peak_mem_gib=mpeak)
        W = torch.as_tensor(r.w, device="cuda")
        H = torch.as_tensor(r.h.T.copy(), device="cuda")
        d = torch.as_tensor(r.d, device="cuda")
        return out, (W, H, d)

    # the f32 route (SINGLET_TPU_MASKGRAM=xla): one traced iteration, then
    # one masked step at the masked fast-phase cap and one test MSE, each
    # under the profiler, from its factors
    with _env(SINGLET_TPU_MASKGRAM="xla"):
        fns_f32 = _build_local_fns(data, MASKED["inv_density"])
        masked, (W, H, d) = masked_fit("f32 route", L["masked_maxit_f32"],
                                       lambda steps: _launches(
                                           B2=steps * (blocks + 1),
                                           B3=steps * blocks,
                                           B4=steps * blocks))
    masked["profile"] = _profile(torch, card, lambda: fns_f32["masked"](
        W, H, seed, 0.01, 0.01, 0.0, 0.0, k,
        sweep_cap=float(settings.fast_masked)),
        label=f"large masked ELL step, f32 route (sweep cap "
              f"{settings.fast_masked})")
    masked["mse_profile"] = _profile(
        torch, card, lambda: fns_f32["mse"](W, d, H, seed),
        label="large test MSE, f32 route")

    # the bits route, the default on the card: the pack once per fit, the
    # fit with its exact launch counts (per iteration a B5, B6, B8 and B2 per
    # block, a B9 per group of 16 blocks, one B2 over all genes, one B7),
    # then one step and one test MSE timed and under the profiler
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    bits = fns["prepare_bits"](seed)
    torch.cuda.synchronize()
    pack_s = time.perf_counter() - t0
    words_gib = bits[0].numel() * 4 / 2**30
    print(f"large test mask packed into bitplane words: {pack_s:.3f} s, "
          f"{words_gib:.3f} GiB ({card})", flush=True)
    F = 16
    bits_fit, (W, H, d) = masked_fit(
        "bits route, int8", L["masked_maxit"], lambda steps: _launches(
            B2=steps * (blocks + 1), B5=steps * blocks, B6=steps * blocks,
            B7=steps, B8=steps * blocks, B9=steps * blocks // F,
            pairs=steps * (blocks + 1)))

    def step():
        return fns["masked"](W, H, seed, 0.01, 0.01, 0.0, 0.0, k,
                             sweep_cap=float(settings.fast_masked),
                             bits=bits)

    def mse():
        return fns["mse"](W, d, H, seed, bits=bits)

    _, step_s, n_step = _counted(torch, step)
    _, mse_s, n_mse = _counted(torch, mse)
    if n_step != _launches(B2=blocks + 1, B5=blocks, B6=blocks, B8=blocks,
                           B9=blocks // F, pairs=blocks + 1) \
            or n_mse != _launches(B7=1):
        raise AssertionError(f"large bits step launches {n_step}, test MSE "
                             f"{n_mse}")
    # the pair operands of one more step, by side: a launch per cell block
    # (h) and one for W (w), with their device time by CUDA events, and no
    # call of the eager chain
    side = (lambda X, out, scales:
            "w" if X.shape[0] == data.genes_pad else "h")
    with _event_timed(torch, (("quantized_pairs_cuda", side),),
                      module=maskgram_cuda) as ev_pairs:
        _, _, n_pairs = _counted(torch, step)
    if {key: calls for key, (_, calls) in ev_pairs.items()} != dict(
            h=blocks, w=1) or n_pairs["pairs"] != blocks + 1 \
            or n_pairs["plain_maskgram"]:
        raise AssertionError(f"large bits step: pair launches {ev_pairs}, "
                             f"counted {n_pairs}")
    print(f"large bits route: the pair operands of one step, {blocks} h-side "
          f"launches {ev_pairs['h'][0]:.3f} ms, 1 w-side "
          f"{ev_pairs['w'][0]:.3f} ms by CUDA events, no plain call "
          f"({card})", flush=True)
    # B7 alone over all cells, by CUDA events (the profiler has shown no
    # device time for it: see PERF.md)
    from singlet_tpu_torch.ops.bell_cuda import bell_mse_bits_cuda

    Wd = W * d[None, :]
    b7_ms = _median_ms(torch, lambda: bell_mse_bits_cuda(
        li, lv, bits[0], Wd, H, gene_block=L["gene_block"]), runs=5)
    print(f"large bits route: one masked step {step_s * 1e3:.1f} ms (sweep "
          f"cap {settings.fast_masked}), one test MSE {mse_s * 1e3:.1f} ms, "
          f"of which kernel B7 over all {cells} cells {b7_ms:.3f} ms "
          f"({card})", flush=True)
    bits_fit.update(
        pack_s=pack_s, words_gib=words_gib, step_ms=step_s * 1e3,
        mse_ms=mse_s * 1e3, b7_all_cells_ms=b7_ms, pairs=ev_pairs,
        profile=_profile(torch, card, step, label=f"large masked ELL step, "
                         f"bits route (sweep cap {settings.fast_masked})",
                         share=B8_SHARES + B9_SHARES + (
                             ("bell_spmm_t_kernel", "B6"),
                             ("bell_spmm_kernel", "B5"), B2_SHARE),
                         grids=(B2_SHARE[0],)),
        mse_profile=_profile(torch, card, mse,
                             label="large test MSE, bits route (B7)",
                             share=((("b7_kernel", "b7_bits_kernel"),
                                     "B7"),),
                             events=(("bell_mse_bits_cuda", "B7"),)))
    bits_fit["mask8"] = phase_large_mask8(torch, card, data, bits, step,
                                          step_s * 1e3, (W, H, seed), F)
    del bits
    resume = phase_resume_large(torch, card, eng, data, ckdir)
    return dict(
        genes=genes, cells=cells, nnz=nnz, width=width, k=k,
        gen_s=gen_s, planes_gib=planes_gib, kernels=kernel_rows,
        bits_kernels=bits_rows, hash_kernels=hash_rows,
        plain=dict(iters=iters, wall_s=secs, ms_per_iter=ms_it,
                   cells_per_s=cells * 1e3 / ms_it, launches=n_fit,
                   final_tol=res["tol_trace"][-1], peak_mem_gib=peak),
        project=dict(wall_s=proj_s, launches=n_proj), profile=profile,
        masked=masked, bits=bits_fit, resume=resume)


def phase_large_mask8(torch, card, data, bits, bits_step, bits_ms, state,
                      F):
    """The bits route's masked step at full width under
    ``SINGLET_TPU_MASK8=1`` (read when the steps are built), from the same
    factors and packed mask: per group of ``F`` blocks one B12 into the
    step's int8 mask buffer and one B14, per block a B13 in place of B8.
    Timed in turns with the bits step, whose first turn (``bits_ms``) the
    caller timed just before (bits, MASK8, MASK8, bits), each with its peak
    device memory; one MASK8 step under the profiler. At the shapes the
    step gives them: B12 on one group's words, the same bytes as its plain
    version, and B14 over that group (``F`` quantization blocks of H's
    packed products, int8, P as the engine hands it over), the same bits
    as its plain version and as B9 on the group's words; each timed (CUDA
    events) with its plain version, B9 and B14 with their passes alone and
    beside torch._int_mm on the unpacked mask."""
    from singlet_tpu_torch.ops import maskbits, maskgram
    from singlet_tpu_torch.ops.linalg import packed_outer_products, triu_pairs
    from singlet_tpu_torch.ops.maskgram_cuda import (
        mask_packed_h_t_bits_cuda, mask_packed_h_t_m8_cuda, pack_mask8_k_cuda,
        pack_words_k_cuda, unpack_mask_bits_cuda)
    from singlet_tpu_torch.ops.nnls import SweepSettings
    from singlet_tpu_torch.parallel.sharded_ell import _build_local_fns

    W, H, seed = state
    k = W.shape[1]
    blocks = data.cells_pad // data.cell_block
    settings = SweepSettings.from_env()
    with _env(SINGLET_TPU_MASK8="1"):
        fns8 = _build_local_fns(data, MASKED["inv_density"])

    def step8():
        return fns8["masked"](W, H, seed, 0.01, 0.01, 0.0, 0.0, k,
                              sweep_cap=float(settings.fast_masked),
                              bits=bits)

    want = {step8: _launches(B2=blocks + 1, B5=blocks, B6=blocks,
                             B12=blocks // F, B13=blocks, B14=blocks // F,
                             pairs=blocks + 1),
            bits_step: _launches(B2=blocks + 1, B5=blocks, B6=blocks,
                                 B8=blocks, B9=blocks // F,
                                 pairs=blocks + 1)}
    times = {step8: [], bits_step: [bits_ms]}
    peaks = {step8: [], bits_step: []}
    outs = {}
    launches = dict.fromkeys(COUNTS, 0)
    for fn in (step8, step8, bits_step):
        torch.cuda.reset_peak_memory_stats()
        outs[fn], secs, n = _counted(torch, fn)
        if n != want[fn]:
            raise AssertionError(f"large step launches {n}, want {want[fn]}")
        if fn is step8:
            launches = {key: launches[key] + n[key] for key in COUNTS}
        times[fn].append(secs * 1e3)
        peaks[fn].append(torch.cuda.max_memory_allocated() / 2**30)
    # int8 (the default mode): the same bits as the bits step
    for got, ref in zip(outs[step8], outs[bits_step]):
        if not torch.equal(got, ref):
            raise AssertionError("large MASK8 step: differs from the bits "
                                 "step")
    # B12 and B14 at the step's shapes against their plain versions
    group, blk = F * data.cell_block, data.cell_block
    G, genes = data.gene_block, data.genes_pad

    def b12(f, out=None):
        return f(bits[0][:group], gene_block=G, genes_pad=genes, out=out)

    m8 = b12(unpack_mask_bits_cuda)
    if not torch.equal(m8, b12(maskbits.unpack_mask_bits_plain)):
        raise AssertionError("large B12 on one group: differs from the plain "
                             "version")
    buf = torch.empty_like(m8)
    unpack_ms = _median_ms(torch, lambda: b12(unpack_mask_bits_cuda, buf),
                           runs=10)
    unpack_plain_ms = _median_ms(
        torch, lambda: b12(maskbits.unpack_mask_bits_plain, buf), runs=2)
    del buf
    iu = triu_pairs(k)
    q = [maskgram.quantize_pairs(packed_outer_products(H[c0:c0 + blk], iu))
         for c0 in range(0, group, blk)]
    Ph_op = torch.cat([x for x, _ in q])
    Ph_s = torch.stack([x for _, x in q], dim=1).contiguous()
    del q
    # P as the engine hands it over (K-major)
    Ph_eng = maskgram.kmajor_buffer(group, Ph_op.shape[1], "cuda")
    Ph_eng.copy_(Ph_op)
    acc0 = torch.rand((iu[0].shape[0], genes),
                      generator=torch.Generator(device="cuda").manual_seed(7),
                      device="cuda")
    w_grp = bits[0][:group]

    def b14(f, acc=None):
        return f(Ph_eng, Ph_s, m8, acc0.clone() if acc is None else acc,
                 gene_block=G, scale_block=blk)

    def b9(acc):
        return mask_packed_h_t_bits_cuda(Ph_eng, Ph_s, w_grp, acc,
                                         gene_block=G, scale_block=blk)

    got = b14(mask_packed_h_t_m8_cuda)
    if not (torch.equal(got, b14(maskgram.mask_packed_h_t_m8_plain))
            and torch.equal(got, b9(acc0.clone()))):
        raise AssertionError("large B14 on one group (int8): differs from "
                             "the plain version or from B9")
    del got
    buf = acc0.clone()
    b14_ms = _median_ms(torch, lambda: b14(mask_packed_h_t_m8_cuda, buf),
                        runs=5)
    b9_ms = _median_ms(torch, lambda: b9(buf), runs=5)
    b9_pass_ms = _median_ms(torch, lambda: pack_words_k_cuda(
        w_grp, gene_block=G, genes_pad=genes), runs=5)
    b14_pass_ms = _median_ms(torch, lambda: pack_mask8_k_cuda(m8), runs=5)
    int_mm_ms = _int_mm_library(torch, Ph_op.T.contiguous(), m8)
    b14_plain_ms = _median_ms(
        torch, lambda: b14(maskgram.mask_packed_h_t_m8_plain, buf), runs=1)
    del buf, acc0, Ph_op, Ph_eng, Ph_s, m8
    print(f"large MASK8 step (sweep cap {settings.fast_masked}): "
          f"{[round(t, 1) for t in times[step8]]} ms against the bits "
          f"step's {[round(t, 1) for t in times[bits_step]]} ms (in turns "
          f"bits, MASK8, MASK8, bits), the same bits; peak "
          f"{max(peaks[step8]):.2f} GiB against {max(peaks[bits_step]):.2f}"
          f" GiB; per group of {group} cells B12 {unpack_ms:.3f} ms (plain "
          f"{unpack_plain_ms:.3f}, the same bytes), B14 {b14_ms:.3f} ms "
          f"(its pass {b14_pass_ms:.3f}; plain {b14_plain_ms:.3f}, int8, the "
          f"same bits), B9 {b9_ms:.3f} ms (its pass {b9_pass_ms:.3f}; the "
          f"same bits as B14), torch._int_mm {int_mm_ms:.3f} ms ({card})",
          flush=True)
    return dict(step_ms=times[step8], bits_step_ms=times[bits_step],
                peak_mem_gib=max(peaks[step8]),
                bits_peak_mem_gib=max(peaks[bits_step]),
                launches=launches,
                unpack_group_ms=unpack_ms,
                unpack_group_plain_ms=unpack_plain_ms, b14_group_ms=b14_ms,
                b14_group_plain_ms=b14_plain_ms, b14_group_pass_ms=b14_pass_ms,
                b9_group_ms=b9_ms, b9_group_pass_ms=b9_pass_ms,
                int_mm_group_ms=int_mm_ms, group_cells=group,
                profile=_profile(torch, card, step8, label=f"large masked ELL "
                                 f"step, MASK8 (sweep cap "
                                 f"{settings.fast_masked})",
                                 share=B13_SHARES + B14_SHARES + (
                                     B2_SHARE,), grids=(B2_SHARE[0],)))


def phase_resume_large(torch, card, eng, data, ckdir):
    """The resumable masked fit at full width: the ELL engine's
    ``ard_fit(checkpoint=, every=1)`` on the card's default mode, whose
    per-step path packs no mask and so takes the hash route (per 2048-cell
    block B3, B10, B2, B4 and B11; one B2 over all genes; the hashed f32
    test MSE, which launches no kernel of the port): 1 iteration, resumed
    to 2, bit for bit an uninterrupted checkpointed 2-iteration run. Then
    one hash-route step, one test MSE and one checkpoint save (the host
    copy included) timed, the step and the MSE under the profiler."""
    from singlet_tpu_torch.checkpoint import CheckpointManager
    from singlet_tpu_torch.ops.nnls import SweepSettings
    from singlet_tpu_torch.ops.rngmask import seed_pair
    from singlet_tpu_torch.parallel.sharded_ell import _build_local_fns
    from singlet_tpu_torch.solvers.als import checkpoint_saver

    k = LARGE["k"]
    blocks = data.cells_pad // data.cell_block
    ard_kw = dict(tol=0.0, trace_test_mse=1, overfit_threshold=1.0,
                  mask_seed=MASKED["mask_seed"],
                  inv_density=MASKED["inv_density"])

    def want(steps):
        return _launches(B2=steps * (blocks + 1), B3=steps * blocks,
                         B4=steps * blocks, B10=steps * blocks,
                         B11=steps * blocks)

    cut = _timed_manager(os.path.join(ckdir, "large_cut"), 1)
    first, first_s, n_first = _counted(torch, lambda: eng.ard_fit(
        k, maxit=1, checkpoint=cut, **ard_kw))
    res, res_s, n_res = _counted(torch, lambda: eng.ard_fit(
        k, maxit=2, checkpoint=cut, **ard_kw))
    full_mgr = _timed_manager(os.path.join(ckdir, "large_full"), 1)
    full, full_s, n_full = _counted(torch, lambda: eng.ard_fit(
        k, maxit=2, checkpoint=full_mgr, **ard_kw))
    if (n_first, n_res, n_full) != (want(1), want(1), want(2)):
        raise AssertionError(f"large hash route launches {n_first}, {n_res}, "
                             f"{n_full}; want 1, 1 and 2 steps of {want(1)}")
    if first.iter != [0] or full.iter != [0, 1]:
        raise AssertionError(f"large hash route iter {first.iter}, "
                             f"{full.iter}")
    if not (np.isfinite(full.test_mse).all() and min(full.test_mse) > 0):
        raise AssertionError(f"large hash route test mse {full.test_mse}")
    _check_fit(full.w, full.d, full.h, (data.genes_true, k),
               (k, data.cells_true))
    _same("large hash route resumed vs uninterrupted", res, full,
          ("w", "h", "d", "test_mse", "iter", "tol", "score_overfit"))
    saves_s = cut.save_s + full_mgr.save_s
    print(f"large resumable masked ELL ard_fit (hash route) k={k}: 1 "
          f"iteration {first_s:.3f} s, resumed to 2 {res_s:.3f} s, bit for "
          f"bit the uninterrupted 2 ({full_s:.3f} s); test mse "
          f"{full.test_mse}; npz writes {[round(s, 3) for s in saves_s]} s; "
          f"launches {n_full} ({card})", flush=True)

    # one hash-route step (the default mode given no packed mask), one
    # hashed test MSE and one save, from the fit's factors
    fns = _build_local_fns(data, MASKED["inv_density"])
    settings = SweepSettings.from_env()
    seed = seed_pair(MASKED["mask_seed"])
    W = torch.as_tensor(full.w, device="cuda")
    H = torch.as_tensor(full.h.T.copy(), device="cuda")
    d = torch.as_tensor(full.d, device="cuda")

    def step():
        return fns["masked"](W, H, seed, 0.01, 0.01, 0.0, 0.0, k,
                             sweep_cap=float(settings.fast_masked))

    def mse():
        return fns["mse"](W, d, H, seed)

    _, step_s, n_step = _counted(torch, step)
    _, mse_s, n_mse = _counted(torch, mse)
    if n_step != want(1) or n_mse != _launches():
        raise AssertionError(f"large hash step launches {n_step}, test MSE "
                             f"{n_mse}")
    saver = checkpoint_saver(CheckpointManager(
        os.path.join(ckdir, "large_save"), every=1), dict(k=k))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    saver(1, W, H, d, {"tol_trace": [1.0]})
    save_s = time.perf_counter() - t0
    print(f"large hash route: one masked step {step_s * 1e3:.1f} ms (sweep "
          f"cap {settings.fast_masked}), one hashed test MSE "
          f"{mse_s * 1e3:.1f} ms, one checkpoint save of W, H and d "
          f"{save_s * 1e3:.1f} ms with the copy to the host ({card})",
          flush=True)
    step_profile = _profile(torch, card, step, label=f"large masked ELL "
                            f"step, hash route (sweep cap "
                            f"{settings.fast_masked})",
                            share=(("bell_spmm_t_kernel", "B4"), B2_SHARE),
                            grids=(B2_SHARE[0],))
    return dict(
        first_s=first_s, resumed_s=res_s, full_s=full_s,
        launches_first=n_first, launches_resumed=n_res, launches_full=n_full,
        test_mse=full.test_mse, npz_write_s=saves_s, step_ms=step_s * 1e3,
        mse_ms=mse_s * 1e3, save_ms=save_s * 1e3, profile=step_profile,
        mse_profile=_profile(torch, card, mse,
                             label="large hashed test MSE (hash route)"))


def phase_ell_entry(torch, card):
    """The user's entry points on the ELL route: the planted rank-10
    operand as scipy CSC, past SPARSE_THRESHOLD, through ard_nmf and
    cross_validate_nmf (each packs the planes from scipy: its wall time
    includes that ingest)."""
    import scipy.sparse as sp

    import singlet_tpu_torch as stt
    from singlet_tpu_torch.solvers.drivers import SPARSE_THRESHOLD

    g, c = BENCH["genes"], BENCH["cells"]
    rank = PLANTED["rank"]
    A = sp.csc_matrix(_planted_operand(g, c, rank, PLANTED["seed"]))
    assert g * c > SPARSE_THRESHOLD
    model, secs, n = _counted(torch, lambda: stt.ard_nmf(
        A, k_max=PLANTED["k_max"], verbose=0, seed=1, device="cuda"))
    ranks = sorted(int(kk) for kk in model.cv_data["k"].unique())
    _check_fit(model.w, model.d, model.h, (g, model.k), (model.k, c))
    if abs(model.k - rank) > 2:
        raise AssertionError(f"ELL ard_nmf selected rank {model.k}, planted "
                             f"{rank}; fitted ranks {ranks}")
    # the masked fits of the search on the default bits route (B2, B5-B9),
    # the final fit at the chosen rank on the plain one (B1, B3, B4)
    if not all(n[key] for key in ("B1", "B2", "B3", "B4", "B5", "B6", "B7",
                                  "B8", "B9", "pairs")) \
            or n["plain"] or n["plain_bell"] or n["plain_maskgram"] \
            or n["plain_maskbits"]:
        raise AssertionError(f"ELL ard_nmf launches {n}")
    print(f"ard_nmf on the planted rank-{rank} {g}x{c} operand as scipy CSC "
          f"({A.nnz} nonzeros, ELL route): selected rank {model.k} after fits "
          f"at ranks {ranks}, {secs:.3f} s with ingest, launches {n} "
          f"({card})", flush=True)
    df, cv_s, n_cv = _counted(torch, lambda: stt.cross_validate_nmf(
        A, ranks=CV_RANKS, n_replicates=1, maxit=20, verbose=0,
        device="cuda"))
    if sorted(df["k"].unique()) != CV_RANKS or \
            not np.isfinite(df["test_error"]).all():
        raise AssertionError(f"ELL cross_validate_nmf frame:\n{df}")
    if not all(n_cv[key] for key in ("B2", "B5", "B6", "B7", "B8", "B9",
                                     "pairs")) \
            or any(n_cv[key] for key in ("B1", "B3", "B4", "plain",
                                         "plain_bell", "plain_maskgram",
                                         "plain_maskbits")):
        raise AssertionError(f"ELL cross_validate_nmf launches {n_cv}")
    best = stt.GetBestRank(df)
    print(f"cross_validate_nmf ranks {CV_RANKS} maxit=20 on the ELL route: "
          f"{cv_s:.3f} s with ingest, launches {n_cv}, GetBestRank {best} "
          f"({card})", flush=True)
    return dict(nnz=int(A.nnz), ard=dict(planted=rank, selected=model.k,
                                         ranks=ranks, wall_s=secs,
                                         launches=n),
                cv=dict(ranks=CV_RANKS, wall_s=cv_s, launches=n_cv,
                        best_rank=best, rows=len(df)))


@contextlib.contextmanager
def _event_timed(torch, names, module=None):
    """Within the block, each wrapper of ``module`` (default
    ``ops/bell_cuda.py``) named in ``names`` (its attribute name and a
    label, or a function of the call's arguments that gives one) records a
    CUDA event before and after each call, on the current stream; yields a
    dict that, after the block, maps each label to [ms, calls]: the device
    time between the events, which bracket the wrapper's one kernel
    launch."""
    from singlet_tpu_torch.ops import bell_cuda

    module = module or bell_cuda
    spans = {label: [] for _, label in names if not callable(label)}
    saved = {attr: getattr(module, attr) for attr, _ in names}

    def timed(fn, label):
        def wrapper(*args, **kwargs):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            out = fn(*args, **kwargs)
            end.record()
            key = label(*args, **kwargs) if callable(label) else label
            spans.setdefault(key, []).append((start, end))
            return out
        return wrapper

    totals = {}
    for attr, label in names:
        setattr(module, attr, timed(saved[attr], label))
    try:
        yield totals
    finally:
        for attr, fn in saved.items():
            setattr(module, attr, fn)
    torch.cuda.synchronize()
    for label, pairs in spans.items():
        totals[label] = [sum(a.elapsed_time(b) for a, b in pairs), len(pairs)]


def _profile(torch, card, fn, label="race", share=(), grids=(), events=()):
    """Device time by kernel over one run of ``fn`` (torch.profiler), and
    the device's idle share of the run's wall time. For each entry of
    ``share`` (a kernel name's key, or a tuple of keys, and its label, as
    ("bell_spmm_t_kernel", "B4")), also those kernels' device time and its
    share of the run's, printed and recorded as ``<label>_ms`` and
    ``<label>_share``. For each key of ``grids``, the device time and
    launches of the kernels whose name holds it, by launch grid (from the
    exported trace), recorded as ``<key>_by_grid``: B2's h-side and w-side
    calls run one kernel on grids of different sizes. For each entry of
    ``events`` (a wrapper of ``ops/bell_cuda.py`` and a label, as
    ("bell_spmm_cuda", "B3")), the device time of its calls inside the
    profiled run by CUDA events, recorded as ``<label>_events_ms``: the
    profiler's list has shown no row for B3 in the plain step and for B7
    in the test MSE. Where the profiler misses a kernel that the events
    time, ``busy_ms_events`` and ``idle_share_events`` add its event time
    to the profiler's busy time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 acc_events=True) as prof:
        # a tiny kernel first: the trace has missed the first kernel
        # launched in its window
        torch.ones(1, device="cuda").add_(1)
        torch.cuda.synchronize()
        with _event_timed(torch, events) as timed_ms:
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            wall_us = (time.perf_counter() - t0) * 1e6
    # device-side events only: an aten op's device time repeats its kernels'
    kernels = {ev.key: ev.self_device_time_total
               for ev in prof.key_averages()
               if ev.device_type == DeviceType.CUDA}
    busy_us = sum(kernels.values())
    top = sorted(kernels.items(), key=lambda kv: -kv[1])[:8]
    print(f"profiled {label}: wall {wall_us / 1e3:.1f} ms (under the "
          f"profiler), "
          f"device busy {busy_us / 1e3:.1f} ms, idle share "
          f"{1 - busy_us / wall_us:.3f} ({card})", flush=True)
    for name, us in top:
        print(f"  {us / 1e3:9.2f} ms  {us / max(busy_us, 1e-9):6.1%}  "
              f"{name[:90]}", flush=True)
    out = dict(wall_ms=wall_us / 1e3, busy_ms=busy_us / 1e3,
               idle_share=1 - busy_us / wall_us,
               kernels_ms={name: us / 1e3 for name, us in top})
    if share and isinstance(share[0], str):
        share = (share,)
    for keys, name in share:
        keys = (keys,) if isinstance(keys, str) else keys
        ms = sum(us for kname, us in kernels.items()
                 if any(key in kname for key in keys)) / 1e3
        out[f"{name}_ms"] = ms
        out[f"{name}_share"] = ms / max(busy_us / 1e3, 1e-9)
        print(f"  kernel {name}: {ms:.2f} ms of {busy_us / 1e3:.1f} ms "
              f"device time ({out[f'{name}_share']:.1%})", flush=True)
    missed_ms = 0.0
    for name, (ms, calls) in timed_ms.items():
        out[f"{name}_events_ms"] = ms
        out[f"{name}_events_calls"] = calls
        seen = out.get(f"{name}_ms", 0.0)
        if seen < 0.5 * ms:
            missed_ms += ms - seen
        print(f"  kernel {name} by CUDA events inside the profiled call: "
              f"{ms:.2f} ms over {calls} calls (the profiler's list "
              f"{seen:.2f} ms)", flush=True)
    if timed_ms:
        out["busy_ms_events"] = busy_us / 1e3 + missed_ms
        out["idle_share_events"] = 1 - out["busy_ms_events"] * 1e3 / wall_us
        print(f"  device busy with the kernels the profiler missed "
              f"{out['busy_ms_events']:.1f} ms, idle share "
              f"{out['idle_share_events']:.3f} ({card})", flush=True)
    if grids:
        path = os.path.join(ROOT, "build", f"trace_{os.getpid()}.json")
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f).get("traceEvents", [])
        os.remove(path)
        for key in grids:
            by_grid = {}
            for ev in events:
                if ev.get("cat") == "kernel" and key in ev.get("name", ""):
                    grid = str(ev.get("args", {}).get("grid"))
                    ms, calls = by_grid.get(grid, (0.0, 0))
                    by_grid[grid] = (ms + ev.get("dur", 0) / 1e3, calls + 1)
            out[f"{key}_by_grid"] = {grid: dict(ms=ms, calls=calls)
                                     for grid, (ms, calls) in by_grid.items()}
            for grid, (ms, calls) in sorted(by_grid.items()):
                print(f"  {key} grid {grid}: {calls} launches, {ms:.2f} ms "
                      f"of {busy_us / 1e3:.1f} ms device time "
                      f"({ms / max(busy_us / 1e3, 1e-9):.1%})", flush=True)
    return out


def _check_launches(label, got, want):
    if got != want:
        raise AssertionError(f"{label}: launches {got}, want {want}")


def _check_only(label, got, keys):
    """Each kernel of ``keys`` launched, nothing else and no plain call."""
    if not all(got[key] for key in keys) or \
            any(got[key] for key in COUNTS if key not in keys):
        raise AssertionError(f"{label}: launches {got}, want {keys} alone")


def _stream_chunk(seed: int, genes: int, cells: int, nnz: int):
    """One host chunk of phase 15's operand: per cell ``nnz`` genes drawn
    uniformly with replacement (the duplicates merged), raw counts 1 +
    Poisson(0.6), as scipy CSC, from a numpy seed."""
    import scipy.sparse as sp

    rng = np.random.default_rng(seed)
    g = np.sort(rng.integers(0, genes, (cells, nnz), dtype=np.int32), axis=1)
    keep = np.ones(g.shape, bool)
    keep[:, 1:] = g[:, 1:] != g[:, :-1]
    indptr = np.zeros(cells + 1, np.int64)
    indptr[1:] = np.cumsum(keep.sum(axis=1))
    indices = g[keep]
    data = (1 + rng.poisson(0.6, indices.size)).astype(np.float32)
    return sp.csc_matrix((data, indices, indptr), shape=(genes, cells))


def _same_planes(torch, label, got, want):
    """Two ShardedEllData on the card hold the same planes, flags and
    geometry, bit for bit."""
    for f in ("b_li", "b_val", "nonempty", "gene_nonempty"):
        if not torch.equal(getattr(got, f), getattr(want, f)):
            raise AssertionError(f"{label}: {f} differs from the monolithic "
                                 f"ingest")
    for f in ("b_width", "genes_true", "cells_true", "genes_pad",
              "cells_pad", "cell_block", "gene_block"):
        if getattr(got, f) != getattr(want, f):
            raise AssertionError(f"{label}: {f} {getattr(got, f)} != "
                                 f"{getattr(want, f)}")


def _synced(torch, fn):
    """(fn(), wall seconds up to a device sync)."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def phase_stream(torch, card, stage_root):
    """Streaming ingest at 131,072 cells: the native library, both packers,
    chunk-list and staged ingest against monolithic ingest, the staged fit
    against the monolithic fit, and a staged cross_validate_nmf. Returns
    (results, the monolithic engine, its W0, the staged fit) for phases 16
    and 17."""
    import scipy.sparse as sp

    import singlet_tpu_torch as stt
    from singlet_tpu_torch import native
    from singlet_tpu_torch.parallel import sharded_ell as tell
    from singlet_tpu_torch.sparse.chunked import stage_chunks

    S = STREAM
    genes, cells, k = S["genes"], S["cells"], S["k"]
    # built in phase 1 (phase_build), beside the CUDA sources
    lib, _, _ = native.build()
    if not native.available():
        raise AssertionError("the native IO library did not load")
    print(f"native IO library {os.path.relpath(lib, ROOT)} loaded",
          flush=True)
    t0 = time.perf_counter()
    chunks = [_stream_chunk(S["seed"] + i, genes, S["chunk"], S["nnz"])
              for i in range(cells // S["chunk"])]
    gen_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    A = sp.hstack(chunks, format="csc")
    hstack_s = time.perf_counter() - t0
    genes_pad, cells_pad, cell_block, gene_block = tell.ell_geometry(
        genes, cells)
    n_gb = genes_pad // gene_block
    t0 = time.perf_counter()
    width = tell.bell_width(tell.bell_widths(A, n_gb, gene_block))
    width_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    li_c, lv_c = native.csc_to_bell(A, cells_pad, gene_block, n_gb, width)
    cpp_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    li_n, lv_n = native._csc_to_bell_numpy(A, cells_pad, gene_block, n_gb,
                                           width)
    numpy_s = time.perf_counter() - t0
    if not (np.array_equal(li_c, li_n) and np.array_equal(lv_c, lv_n)):
        raise AssertionError("C++ and numpy csc_to_bell planes differ")
    planes_gib = (li_c.nbytes + lv_c.nbytes) / 2**30
    del li_c, lv_c, li_n, lv_n
    print(f"stream operand {genes} x {cells}, {A.nnz} nonzeros in "
          f"{len(chunks)} chunks (made in {gen_s:.3f} s, joined in "
          f"{hstack_s:.3f} s), width {width} ({width_s:.3f} s): csc_to_bell "
          f"C++ {cpp_s:.3f} s, numpy {numpy_s:.3f} s, the same planes, "
          f"{planes_gib:.3f} GiB ({card})", flush=True)

    mono, mono_s = _synced(torch, lambda: tell.shard_ell_data(A, "cuda"))
    data, chunks_s = _synced(torch, lambda: tell.shard_ell_from_chunks(
        chunks, "cuda"))
    _same_planes(torch, "chunk list", data, mono)
    del data
    staged = {}
    for name, value_compress in (("v1", False), ("v2", True)):
        d = os.path.join(stage_root, name)
        _, stage_s = _synced(torch, lambda: stage_chunks(
            d, chunks, value_compress=value_compress))
        disk = sum(os.path.getsize(os.path.join(d, f))
                   for f in os.listdir(d))
        data, ingest_s = _synced(torch, lambda: tell.shard_ell_from_staged(
            d, "cuda"))
        _same_planes(torch, f"staged {name}", data, mono)
        del data
        staged[name] = dict(dir=d, stage_s=stage_s, bytes=disk,
                            ingest_s=ingest_s)
    print(f"ingest on the card: monolithic {mono_s:.3f} s, chunk list "
          f"{chunks_s:.3f} s, staged v1 {staged['v1']['ingest_s']:.3f} s, "
          f"v2 {staged['v2']['ingest_s']:.3f} s, all the same planes bit "
          f"for bit; staging v1 {staged['v1']['stage_s']:.3f} s "
          f"{staged['v1']['bytes']} bytes, v2 {staged['v2']['stage_s']:.3f} "
          f"s {staged['v2']['bytes']} bytes ({card})", flush=True)
    del A, chunks

    W0 = np.random.default_rng(S["seed"]).random((genes, k),
                                                 dtype=np.float32)
    eng = stt.ShardedEllEngine(None, data=mono)
    fit_kw = dict(rank=k, tol=0.0, maxit=S["maxit"], w_init=W0,
                  device="cuda")
    m_dir, dir_s, n_dir = _counted(torch, lambda: stt.run_nmf(
        staged["v2"]["dir"], **fit_kw))
    m_mono, mono_fit_s, n_mono = _counted(torch, lambda: stt.run_nmf(
        eng, **fit_kw))
    want = _launches(B1=2 * S["maxit"], B3=S["maxit"], B4=S["maxit"])
    _check_launches("staged run_nmf", n_dir, want)
    _check_launches("monolithic run_nmf", n_mono, want)
    _check_fit(m_dir.w, m_dir.d, m_dir.h, (genes, k), (k, cells))
    for f in ("w", "d", "h"):
        if not np.array_equal(getattr(m_dir, f), getattr(m_mono, f)):
            raise AssertionError(f"staged fit's {f} differs from the "
                                 f"monolithic fit's")
    df, cv_s, n_cv = _counted(torch, lambda: stt.cross_validate_nmf(
        staged["v1"]["dir"], ranks=[S["cv_rank"]], n_replicates=1,
        maxit=S["cv_maxit"], verbose=0, device="cuda"))
    if list(df["k"].unique()) != [S["cv_rank"]] or \
            not np.isfinite(df["test_error"]).all():
        raise AssertionError(f"staged cross_validate_nmf frame:\n{df}")
    _check_only("staged cross_validate_nmf", n_cv,
                ("B2", "B5", "B6", "B7", "B8", "B9", "pairs"))
    print(f"run_nmf on the staged v2 directory k={k} maxit={S['maxit']}: "
          f"{dir_s:.3f} s with ingest, bit for bit the monolithic engine's "
          f"fit ({mono_fit_s:.3f} s), launches {n_dir}; cross_validate_nmf "
          f"on the v1 directory at rank {S['cv_rank']}, maxit "
          f"{S['cv_maxit']}: {cv_s:.3f} s with ingest, launches {n_cv} "
          f"({card})", flush=True)
    return dict(genes=genes, cells=cells, nnz=int(mono.b_li.ge(0).sum()),
                width=width, planes_gib=planes_gib, gen_s=gen_s,
                hstack_s=hstack_s, width_s=width_s, cpp_s=cpp_s,
                numpy_s=numpy_s, mono_s=mono_s, chunks_s=chunks_s,
                staged={v: {key: x for key, x in st.items() if key != "dir"}
                        for v, st in staged.items()},
                run_nmf=dict(staged_s=dir_s, mono_s=mono_fit_s,
                             launches=n_dir, launches_mono=n_mono),
                cv=dict(wall_s=cv_s, launches=n_cv, rows=len(df),
                        test_error=df["test_error"].tolist())), eng, W0, \
        m_dir


def phase_wide_block_stream(torch, card, staged_dir, eng512, W0):
    """Phase 15's operand (131,072 x 16,384, k = 100) on the ELL engine
    ingested from its staged directory at gene block 8,192 (B3 and B5 on
    the wide-block route) and, for comparison, phase 15's monolithic
    engine at 512 (their tiles): per gene block 3 plain iterations from
    W0 (ms each, B3 by CUDA events inside them) and one bits-route masked
    step from their factors (B5 by CUDA events inside it); the two plain
    fits within FIT_RTOL/FIT_ATOL of each other."""
    from singlet_tpu_torch.ops import bell_cuda
    from singlet_tpu_torch.ops.nnls import SweepSettings
    from singlet_tpu_torch.ops.rngmask import seed_pair
    from singlet_tpu_torch.parallel import sharded_ell as tell

    S, M = STREAM, WIDE_STREAM["maxit"]
    k = S["k"]
    seed = seed_pair(MASKED["mask_seed"])
    fast = float(SweepSettings.from_env().fast_masked)
    out, fits = {}, {}
    for G in WIDE_STREAM["gene_blocks"]:
        if G == eng512.data.gene_block:
            eng, ingest_s = eng512, None
        else:
            data, ingest_s = _synced(torch, lambda: tell.shard_ell_from_staged(
                staged_dir, "cuda", gene_block=G))
            eng = tell.ShardedEllEngine(None, data=data)
        data = eng.data
        cells, blocks = data.cells_pad, data.cells_pad // data.cell_block
        wide = {bits: isinstance(bell_cuda.b3_plan(
            cells, data.n_gb, G, data.b_width, k, bits), bell_cuda.B3WidePlan)
            for bits in (False, True)}
        with _event_timed(torch, (("bell_spmm_cuda", "B3"),)) as ev3:
            res, secs, n_fit = _counted(torch, lambda: eng.fit(
                k, w_init=W0, tol=0.0, maxit=M))
        _check_launches(f"gene block {G} plain fit", n_fit, _launches(
            B1=2 * M, B3=M, B3w=M * wide[False], B4=M))
        _check_fit(res["w"], res["d"], res["h"], (S["genes"], k),
                   (k, S["cells"]))
        fits[G] = res
        fns = tell._build_local_fns(data, MASKED["inv_density"])
        bits = fns["prepare_bits"](seed)
        W = torch.as_tensor(res["w"], device="cuda")
        H = torch.zeros((cells, k), device="cuda")
        H[:S["cells"]] = torch.as_tensor(res["h"].T.copy(), device="cuda")

        def step():
            return fns["masked"](W, H, seed, 0.01, 0.01, 0.0, 0.0, k,
                                 sweep_cap=fast, bits=bits)

        step()   # its lazily built buffers
        with _event_timed(torch, (("bell_spmm_bits_cuda", "B5"),)) as ev5:
            _, step_s, n_step = _counted(torch, step)
        _check_launches(f"gene block {G} bits step", n_step, _launches(
            B2=blocks + 1, B5=blocks, B5w=blocks * wide[True], B6=blocks,
            B8=blocks, B9=-(-blocks // 16), pairs=blocks + 1))
        del bits, fns
        out[G] = dict(width=data.b_width, n_gb=data.n_gb, ingest_s=ingest_s,
                      wide_b3=wide[False], wide_b5=wide[True],
                      plain_ms_per_iter=secs * 1e3 / M, launches=n_fit,
                      b3_ms=ev3["B3"][0] / ev3["B3"][1],
                      b3_calls=ev3["B3"][1], step_ms=step_s * 1e3,
                      step_launches=n_step,
                      b5_ms=ev5["B5"][0] / ev5["B5"][1],
                      b5_calls=ev5["B5"][1])
        o = out[G]
        print(f"stream operand at gene block {G} (width {o['width']}, "
              f"{o['n_gb']} gene blocks, B3/B5 "
              f"{'wide-block route' if wide[False] else 'tiles'}"
              f"{'' if ingest_s is None else f', staged ingest {ingest_s:.3f} s'}"
              f"): {M} plain iterations {o['plain_ms_per_iter']:.2f} ms "
              f"each, B3 {o['b3_ms']:.3f} ms a call by CUDA events; one "
              f"bits-route masked step (sweep cap {fast:g}) "
              f"{o['step_ms']:.1f} ms, B5 {o['b5_ms']:.4f} ms a call "
              f"({o['b5_calls']} calls) ({card})", flush=True)
        if eng is not eng512:
            del eng, data
    a, b = (fits[G] for G in WIDE_STREAM["gene_blocks"])
    for f in ("w", "h", "d"):
        np.testing.assert_allclose(a[f], b[f], rtol=FIT_RTOL, atol=FIT_ATOL,
                                   err_msg=f"gene blocks {f}")
    print(f"stream operand: the plain fits at gene blocks "
          f"{WIDE_STREAM['gene_blocks']} from one W0 within rtol={FIT_RTOL} "
          f"atol={FIT_ATOL} ({card})", flush=True)
    return out


def _logged(torch, fn):
    """``_counted`` with the metric log on: (result, wall seconds, launch
    counts, the median of the fit's logged iteration times in ms, host
    clock with the loop's sync each iteration, None without iterations;
    the logged tol of each iteration)."""
    from singlet_tpu_torch.tracing import metric_logging

    with metric_logging() as log:
        out, secs, n = _counted(torch, fn)
    its = [e for e in log.events if e["event"] == "iteration"]
    ms = [e["ms"] for e in its]
    return (out, secs, n, statistics.median(ms) if ms else None,
            [e["tol"] for e in its])


def _sorted_model(out):
    """An engine fit's dict as an NMFModel sorted by d, as the drivers
    finalize it."""
    from singlet_tpu_torch import NMFModel

    return NMFModel(w=out["w"], d=out["d"], h=out["h"]).sorted_by_d()


def _fit_gate(label, got, want, fields=("w", "d", "h")):
    for f in fields:
        g = got[f] if isinstance(got, dict) else getattr(got, f)
        w = want[f] if isinstance(want, dict) else getattr(want, f)
        np.testing.assert_allclose(g, w, rtol=FIT_RTOL, atol=FIT_ATOL,
                                   err_msg=f"{label}: {f}")


@contextlib.contextmanager
def _mu_init_from(u, z):
    """``mu_nmf`` starts from the numpy W ``u`` and H ``z`` on any device
    (the card's and the CPU's generators draw apart)."""
    import torch

    from singlet_tpu_torch.solvers import mu

    real = mu._mu_init
    mu._mu_init = lambda g, c, k, seed, device: (
        torch.as_tensor(u, device=device), torch.as_tensor(z, device=device))
    try:
        yield
    finally:
        mu._mu_init = real


def _spatial_points(rng, n, radius, per_disc, features):
    """Synthetic spatial data: n points uniform in a square whose density
    puts ``per_disc`` points in a disc of ``radius``, and U(0, 1)
    profiles (features, n)."""
    side = np.float32(np.sqrt(np.pi * radius ** 2 * n / per_disc))
    cx, cy = (rng.random((2, n), dtype=np.float32) * side)
    return rng.random((features, n), dtype=np.float32), cx, cy


def _solvers_small(torch, card):
    """Each new entry point on the card against the same call on the
    CPU."""
    import scipy.sparse as sp

    import singlet_tpu_torch as stt

    rng = np.random.default_rng(SOLVERS["seed"])
    genes, cells, k, maxit = 512, 1000, 8, 5
    A = np.log1p(rng.poisson(0.3, (genes, cells))).astype(np.float32)
    w0 = rng.random((genes, k), dtype=np.float32)
    bid = rng.integers(0, 3, cells)
    link_h = np.ones((k, cells), np.float32)
    link_h[0, : cells // 2] = 0.0
    M, cx, cy = _spatial_points(rng, cells, 2.0, 12, 6)
    G = stt.local_knn(M, cx, cy, k=6, radius=2.0, device="cpu")
    kw = dict(tol=0.0, maxit=maxit, w_init=w0)
    calls = {
        "run_linked_nmf": lambda dev: stt.run_linked_nmf(
            A, w0, link_h=link_h, tol=0.0, maxit=maxit, verbose=False,
            device=dev),
        "nmf_batch": lambda dev: stt.nmf_batch(A, k, bid, device=dev, **kw),
        "gcnmf": lambda dev: stt.gcnmf(A, G, k, device=dev, **kw),
        "batch_fit": lambda dev: _sorted_model(stt.ShardedEllEngine(
            sp.csc_matrix(A), device=dev, cell_block=512,
            gene_block=256).batch_fit(bid, k, **kw)),
        "gcnmf_fit": lambda dev: _sorted_model(stt.ShardedEllEngine(
            sp.csc_matrix(A), device=dev, cell_block=512,
            gene_block=256).gcnmf_fit(G, k, **kw)),
    }
    for name, call in calls.items():
        _fit_gate(name, call("cuda"), call("cpu"))
    h, d = stt.project_model(A, w0, device="cuda")
    h_c, d_c = stt.project_model(A, w0, device="cpu")
    _fit_gate("project_model", dict(h=h, d=d), dict(h=h_c, d=d_c),
              ("h", "d"))
    u = rng.random((genes, k), dtype=np.float32) + np.float32(1e-3)
    z = np.abs(rng.standard_normal((k, cells), dtype=np.float32)) + \
        np.float32(1e-3)
    with _mu_init_from(u, z):
        for faithful in (False, True):
            got, want = (stt.mu_nmf(A, k, tol=0.0, maxit=3,
                                    faithful=faithful, device=dev)
                         for dev in ("cuda", "cpu"))
            _fit_gate(f"mu_nmf faithful={faithful}", got, want,
                      ("w", "h", "tol_trace"))
    # integer profiles on a grid of integer coordinates: every distance is
    # exact in float32, so both devices select the same edges
    side = 40
    Mi = rng.integers(0, 4, (8, side * side)).astype(np.float32)
    gx = (np.arange(side * side) % side).astype(np.float32)
    gy = (np.arange(side * side) // side).astype(np.float32)
    edges = {}
    for metric in ("euclidean", "jaccard", "cosine", "manhattan", "hamming"):
        got, want = (stt.local_knn(Mi, gx, gy, k=10, radius=3.0,
                                   metric=metric, block=256, device=dev)
                     for dev in ("cuda", "cpu"))
        if not (np.array_equal(got.indptr, want.indptr)
                and np.array_equal(got.indices, want.indices)):
            raise AssertionError(f"local_knn {metric}: edges differ")
        np.testing.assert_allclose(got.data, want.data, rtol=1e-4)
        edges[metric] = int(got.nnz)
    S_g, S_c = (stt.snn_graph(got, 0.05, device=dev)
                for dev in ("cuda", "cpu"))
    if not (np.array_equal(S_g.indices, S_c.indices)
            and np.array_equal(S_g.data, S_c.data)):
        raise AssertionError("snn_graph differs between the card and CPU")
    E = stt.spatial_graph(gx, gy, max_dist=3.0, max_k=20)
    np.testing.assert_allclose(np.asarray(E.sum(axis=0)).ravel(), 1.0,
                               rtol=1e-9)
    print(f"remaining solvers {genes}x{cells} k={k}: run_linked_nmf, "
          f"project_model, nmf_batch, batch_fit, gcnmf, gcnmf_fit, mu_nmf "
          f"(both steps) on the card within rtol={FIT_RTOL} atol={FIT_ATOL} "
          f"of the CPU; local_knn edges {edges} and snn_graph "
          f"({S_g.nnz} edges) the same on both ({card})", flush=True)
    return dict(local_knn_edges=edges, snn_edges=int(S_g.nnz),
                spatial_edges=int(E.nnz))


def _solvers_bench(torch, card):
    """At the bench config from one W0: the engine's linked fit,
    projection, batch_fit and gcnmf_fit against the dense side."""
    import scipy.sparse as sp

    import singlet_tpu_torch as stt
    from singlet_tpu_torch.solvers.als import make_dense_providers

    A, W0 = _bench_operand()
    g, c, k = BENCH["genes"], BENCH["cells"], BENCH["k"]
    maxit = SOLVERS["maxit"]
    rng = np.random.default_rng(SOLVERS["seed"])
    P = make_dense_providers(A, device="cuda")
    eng = stt.ShardedEllEngine(sp.csc_matrix(A), device="cuda")
    link_h = np.ones((k, c), np.float32)
    link_h[0, : c // 2] = 0.0
    link_w = np.ones((g, k), np.float32)
    link_w[: g // 4, 1] = 0.0
    bid = rng.integers(0, SOLVERS["batches"], c)
    M, cx, cy = _spatial_points(rng, c, SOLVERS["radius"],
                                SOLVERS["per_disc"], SOLVERS["features"])
    G, knn_s = _synced(torch, lambda: stt.local_knn(
        M, cx, cy, k=SOLVERS["knn"], radius=SOLVERS["radius"],
        device="cuda"))
    lk = dict(link_h=link_h, link_w=link_w, tol=0.0, maxit=maxit,
              verbose=False)
    kw = dict(tol=0.0, maxit=maxit, w_init=W0)
    plain = _launches(B1=2 * maxit, B3=maxit, B4=maxit)
    runs = {
        "linked": (lambda: stt.run_linked_nmf(eng, W0, **lk),
                   lambda: stt.run_linked_nmf(P, W0, **lk), plain),
        "batch": (lambda: _sorted_model(eng.batch_fit(bid, k, **kw)),
                  lambda: stt.nmf_batch(A, k, bid, device="cuda", **kw),
                  plain),
        "gcnmf": (lambda: _sorted_model(eng.gcnmf_fit(G, k, **kw)),
                  lambda: stt.gcnmf(A, G, k, device="cuda", **kw),
                  _launches(B1=2 * maxit, B3=3 * maxit, B4=maxit)),
        "project": (lambda: dict(zip("hd", stt.project_model(eng, W0))),
                    lambda: dict(zip("hd", stt.project_model(P, W0))),
                    _launches(B1=1, B3=1)),
    }
    out = dict(local_knn_s=knn_s, G_edges=int(G.nnz))
    for name, (engine_fn, dense_fn, want) in runs.items():
        got, eng_s, n_eng, eng_ms, eng_tols = _logged(torch, engine_fn)
        ref, dense_s, n_dense, dense_ms, dense_tols = _logged(torch,
                                                              dense_fn)
        _check_launches(f"{name} on the engine", n_eng, want)
        _check_launches(f"{name} dense", n_dense, _launches(B1=want["B1"]))
        # equal iteration counts, the tol traces and the factors within
        # the fit gate (a projection runs no iteration)
        if len(eng_tols) != len(dense_tols) or \
                len(eng_tols) != (0 if name == "project" else maxit):
            raise AssertionError(f"{name}: {len(eng_tols)} iterations on "
                                 f"the engine, {len(dense_tols)} dense")
        np.testing.assert_allclose(eng_tols, dense_tols, rtol=FIT_RTOL,
                                   atol=FIT_ATOL, err_msg=f"{name} tol")
        _fit_gate(f"{name} engine vs dense", got, ref,
                  ("h", "d") if name == "project" else ("w", "d", "h"))
        out[name] = dict(engine_s=eng_s, dense_s=dense_s,
                         engine_ms_per_iteration=eng_ms,
                         dense_ms_per_iteration=dense_ms,
                         iterations=len(eng_tols), tol_trace=eng_tols,
                         tol_trace_dense=dense_tols,
                         launches=n_eng, launches_dense=n_dense)
    print(f"bench config {g}x{c} k={k}, {maxit} iterations: engine against "
          f"dense within rtol={FIT_RTOL} atol={FIT_ATOL}, equal iteration "
          f"counts and tol traces (wall s, engine / "
          f"dense; median ms per iteration): "
          + ", ".join(f"{name} {out[name]['engine_s']:.3f} / "
                      f"{out[name]['dense_s']:.3f} s"
                      + (f" ({out[name]['engine_ms_per_iteration']:.2f} / "
                         f"{out[name]['dense_ms_per_iteration']:.2f} ms)"
                         if name != "project" else "")
                      for name in runs)
          + f"; G from local_knn ({G.nnz} edges) in {knn_s:.3f} s ({card})",
          flush=True)
    return out


def _solvers_large(torch, card, eng, W0):
    """batch_fit and gcnmf_fit on phase 15's engine at k=100, G's planes,
    and B3 on G's planes against A's."""
    import singlet_tpu_torch as stt
    from singlet_tpu_torch.ops.bell import bell_spmm

    data = eng.data
    cells, k = data.cells_true, W0.shape[1]
    maxit = SOLVERS["large_maxit"]
    rng = np.random.default_rng(SOLVERS["seed"] + 1)
    bid = rng.integers(0, SOLVERS["batches"], cells)
    M, cx, cy = _spatial_points(rng, cells, SOLVERS["radius"],
                                SOLVERS["per_disc"], SOLVERS["features"])
    G, knn_s = _synced(torch, lambda: stt.local_knn(
        M, cx, cy, k=SOLVERS["knn"], radius=SOLVERS["radius"],
        device="cuda"))
    g, graph_s = _synced(torch, lambda: eng.graph_data(G))
    g_gib = 2 * g.b_li.numel() * 4 / 2**30
    gen = torch.Generator(device="cuda").manual_seed(SOLVERS["seed"])
    X = torch.rand((data.cells_pad, k), generator=gen, device="cuda")
    Wt = torch.rand((data.genes_pad, k), generator=gen, device="cuda")
    # B3 over each set of planes at k=100, twice 10 calls (the operand X
    # stands for B or H on G's planes, W on A's); the bound reads the
    # planes and the operand once and writes the (cells_pad, k) output
    b3 = {}
    for name, planes, op in (("G", g, X), ("A", data, Wt)):
        def call():
            return bell_spmm(planes.b_li, planes.b_val, op,
                             gene_block=planes.gene_block)
        nnz = int((planes.b_li >= 0).sum())
        b3[name] = dict(
            ms=_median_ms(torch, call, runs=10),
            ms_again=_median_ms(torch, call, runs=10),
            width=planes.b_width, gene_blocks=planes.n_gb, nnz=nnz,
            **_bound(8 * planes.b_li.numel() + 4 * op.numel()
                     + 4 * data.cells_pad * k, 2 * nnz * k, F32_OPS_S))
    del X, Wt
    kw = dict(tol=0.0, maxit=maxit, w_init=W0)
    out = dict(local_knn_s=knn_s, graph_s=graph_s, G_edges=int(G.nnz),
               G_width=g.b_width, G_gene_blocks=g.n_gb, G_gib=g_gib, b3=b3)
    out["G"] = G
    del g
    for name, fn, want in (
            ("batch_fit", lambda: eng.batch_fit(bid, k, **kw),
             _launches(B1=2 * maxit, B3=maxit, B4=maxit)),
            ("gcnmf_fit", lambda: eng.gcnmf_fit(G, k, **kw),
             _launches(B1=2 * maxit, B3=3 * maxit, B4=maxit))):
        res, secs, n, ms, _ = _logged(torch, fn)
        _check_launches(f"large {name}", n, want)
        if len(res["tol_trace"]) != maxit:
            raise AssertionError(f"large {name}: {res['tol_trace']}")
        _check_fit(res["w"], res["d"], res["h"], (data.genes_true, k),
                   (k, cells))
        out[name] = dict(wall_s=secs, ms_per_iteration=ms, launches=n,
                         tol_trace=res["tol_trace"])
    print(f"large {data.genes_true}x{cells} k={k}, {maxit} iterations "
          f"(median ms per iteration; wall s with set-up, gcnmf_fit's "
          f"packing of G included): batch_fit "
          f"{out['batch_fit']['ms_per_iteration']:.2f} "
          f"({out['batch_fit']['wall_s']:.3f} s), gcnmf_fit "
          f"{out['gcnmf_fit']['ms_per_iteration']:.2f} "
          f"({out['gcnmf_fit']['wall_s']:.3f} s); G from local_knn "
          f"({G.nnz} edges) in {knn_s:.3f} s, its planes width "
          f"{out['G_width']}, {out['G_gene_blocks']} gene blocks, "
          f"{g_gib:.3f} GiB, packed in {graph_s:.3f} s; B3 on G's planes "
          f"{b3['G']['ms']:.4f} / {b3['G']['ms_again']:.4f} ms (bound "
          f"{b3['G']['bound_ms']:.4f}), on A's {b3['A']['ms']:.4f} / "
          f"{b3['A']['ms_again']:.4f} ms (bound {b3['A']['bound_ms']:.4f}) "
          f"({card})", flush=True)
    return out


def phase_solvers(torch, card, eng, W0):
    """Phase 16; returns (its results, the graph G of the large fits)."""
    out = dict(small=_solvers_small(torch, card),
               bench=_solvers_bench(torch, card),
               large=_solvers_large(torch, card, eng, W0))
    return out, out["large"].pop("G")


# phase 17: the mesh on the card. MESH: the fits of phase 17 (the staged
# operand of phase 15 at k=100, the bench config's dense mesh engine), the
# two processes' time limit, and the probe's collectives
MESH = dict(maxit=3, ard_maxit=2, gcnmf_maxit=2, dense_maxit=3,
            dense_masked_maxit=2, world=2, timeout=300)


def _collected(torch, fn):
    """``_logged`` with the collectives counted and timed: (result, wall s,
    launch counts, median ms per iteration, {"calls", "bytes", "ms"} of
    the collectives over the run)."""
    from singlet_tpu_torch.parallel import collectives

    collectives.reset_counts(timed=True)
    out, secs, n, ms, _ = _logged(torch, fn)
    coll = collectives.counts()
    collectives.reset_counts(timed=False)
    return out, secs, n, ms, coll


def _mesh_fits(torch, stt, eng, W0, G, bench, device, mesh):
    """The fits phase 17 holds across worlds, on ``eng`` (phase 15's
    operand; on ``mesh``), and the dense mesh engine on the bench config's
    ``bench`` = (A, W0): {name: (fields, wall s, launches, ms per
    iteration, collectives, iterations)}."""
    S, M = STREAM, MESH
    k = S["k"]
    A_b, W0_b = bench
    runs = {
        "fit": lambda: eng.fit(k, tol=0.0, maxit=M["maxit"], w_init=W0),
        "ard": lambda: eng.ard_fit(k, w_init=W0, tol=0.0,
                                   maxit=M["ard_maxit"]),
        "gcnmf": lambda: eng.gcnmf_fit(G, k, tol=0.0,
                                       maxit=M["gcnmf_maxit"], w_init=W0),
        "dense": lambda: stt.sharded_nmf_fit(
            A_b, BENCH["k"], mesh=mesh, tol=0.0, maxit=M["dense_maxit"],
            w_init=W0_b, device=device),
        "dense_masked": lambda: stt.sharded_nmf_fit(
            A_b, BENCH["k"], mesh=mesh, tol=0.0,
            maxit=M["dense_masked_maxit"], masked=True,
            inv_density=MASKED["inv_density"],
            mask_seed=MASKED["mask_seed"], w_init=W0_b, device=device)}
    out = {}
    for name, fn in runs.items():
        res, secs, n, ms, coll = _collected(torch, fn)
        if not isinstance(res, dict):
            res = dict(w=res.w, d=res.d, h=res.h, tol_trace=res.tol,
                       test_mse=res.test_mse, iter=res.iter)
        its = len(res["tol_trace"]) if name != "ard" else \
            len(res["iter"])
        out[name] = (res, secs, n, ms, coll, its)
    return out


def mesh_worker(argv) -> int:
    """One rank of phase 17(b): ``chip_smoke.py --mesh-worker RANK WORLD
    DIR STAGED``. Joins the gloo world through ``DIR/store`` on cuda:0
    (the ranks share the card), reads only its shards of the staged
    directory, runs ``_mesh_fits`` and saves what it measured to
    ``DIR/rank<RANK>.npz`` (w, d and the traces; h on rank 0 only), then
    probes which collectives gloo takes on CUDA tensors."""
    import scipy.sparse as sp
    import torch
    import torch.distributed as dist

    import singlet_tpu_torch as stt
    from singlet_tpu_torch.parallel import sharded_ell as tell

    rank, world, out, staged = int(argv[0]), int(argv[1]), argv[2], argv[3]
    t_start = time.perf_counter()
    stt.initialize(coordinator_address="file://" + os.path.join(out,
                                                                "store"),
                   num_processes=world, process_id=rank, backend="gloo",
                   device="cuda:0")
    mesh = stt.make_mesh(world, device="cuda:0")
    data, ingest_s = _synced(torch, lambda: tell.shard_ell_from_staged(
        staged, "cuda:0", mesh=mesh))
    eng = stt.ShardedEllEngine(None, data=data)
    W0 = np.random.default_rng(STREAM["seed"]).random(
        (STREAM["genes"], STREAM["k"]), dtype=np.float32)
    G = sp.load_npz(os.path.join(out, "G.npz"))
    fits = _mesh_fits(torch, stt, eng, W0, G, _bench_operand(), "cuda:0",
                      mesh)
    save = dict(ingest_s=ingest_s, cells_local=data.cells_local,
                cell_offset=data.cell_offset)
    for name, (res, secs, n, ms, coll, its) in fits.items():
        keep = ("w", "d", "h") if rank == 0 else ("w", "d")
        save.update({f"{name}_{f}": np.asarray(res[f]) for f in keep})
        save.update({f"{name}_tol_trace": np.asarray(res["tol_trace"]),
                     f"{name}_wall_s": secs, f"{name}_ms": ms,
                     f"{name}_its": its,
                     f"{name}_launches": json.dumps(n),
                     f"{name}_coll": json.dumps(coll)})
        if "test_mse" in res:
            save[f"{name}_test_mse"] = np.asarray(res["test_mse"])
    # which collectives gloo takes on CUDA tensors (the helpers of
    # parallel/collectives.py hand it the tensors where they are): each
    # raises at the call, on both ranks alike, or runs
    t = torch.ones(4, device="cuda:0")
    probes = {
        "all_reduce": lambda: dist.all_reduce(t),
        "all_gather": lambda: dist.all_gather(
            [torch.empty_like(t) for _ in range(world)], t),
        "all_gather_into_tensor": lambda: dist.all_gather_into_tensor(
            torch.empty(world * 4, device="cuda:0"), t),
        "reduce_scatter_tensor": lambda: dist.reduce_scatter_tensor(
            torch.empty(4 // world, device="cuda:0"), t)}
    took = {}
    for name, call in probes.items():
        try:
            call()
            torch.cuda.synchronize()
            took[name] = True
        except Exception as exc:      # the probe's answer, not a fallback
            took[name] = f"{type(exc).__name__}: {exc}"[:200]
    save["gloo_cuda"] = json.dumps(took)
    save["worker_s"] = time.perf_counter() - t_start
    np.savez(os.path.join(out, f"rank{rank}.npz"), **save)
    dist.destroy_process_group()
    return 0


def _mesh_gate(label, got, want, fields=("w", "d", "h")):
    for f in fields:
        np.testing.assert_allclose(got[f], want[f], rtol=FIT_RTOL,
                                   atol=FIT_ATOL, err_msg=f"{label}: {f}")


def _same_bits(label, got, want, fields=("w", "d", "h")):
    for f in fields:
        if not np.array_equal(np.asarray(got[f]), np.asarray(want[f])):
            raise AssertionError(f"{label}: {f} differs")


def phase_mesh(torch, card, stage_root, eng, W0, G, m_dir):
    """Phase 17: (a) a world of one over NCCL in this process, bit for bit
    the fits with no mesh; (b) two gloo processes sharing the card, within
    the fit tolerance of (a), with equal iteration counts and W bits."""
    import dataclasses

    import scipy.sparse as sp
    import torch.distributed as dist

    import singlet_tpu_torch as stt

    t_phase = time.perf_counter()
    S, M = STREAM, MESH
    k = S["k"]
    v1, v2 = (os.path.join(stage_root, v) for v in ("v1", "v2"))
    # (a) a world of one over NCCL
    mesh = stt.make_mesh()
    if dist.get_backend() != "nccl" or mesh.size() != 1:
        raise AssertionError(f"world of one: {dist.get_backend()}, "
                             f"{mesh.size()} ranks")
    try:
        m_mesh, dir_s, n_dir = _counted(torch, lambda: stt.run_nmf(
            v2, rank=k, tol=0.0, maxit=M["maxit"], w_init=W0,
            device="cuda", mesh=mesh))
        _check_launches("run_nmf on a world of one", n_dir, _launches(
            B1=2 * M["maxit"], B3=M["maxit"], B4=M["maxit"]))
        _same_bits("run_nmf on a world of one (phase 15's fit)",
                   vars(m_mesh), vars(m_dir))
        one = stt.ShardedEllEngine(None, data=dataclasses.replace(
            eng.data, mesh=mesh))
        bench = _bench_operand()
        a = _mesh_fits(torch, stt, one, W0, G, bench, "cuda", mesh)
        # the same fits with no mesh, to be the same bits
        none = _mesh_fits(torch, stt, eng, W0, G, bench, "cuda", None)
        del bench
    finally:
        dist.destroy_process_group()
    for name in a:
        _same_bits(f"{name} on a world of one", a[name][0], none[name][0])
        if a[name][5] != none[name][5]:
            raise AssertionError(f"{name}: iterations differ")
    for name, want_keys in (("ard", ("B2", "B5", "B6", "B7", "B8", "B9",
                                     "pairs")),
                            ("fit", ("B1", "B3", "B4")),
                            ("gcnmf", ("B1", "B3", "B4")),
                            ("dense", ("B1",)), ("dense_masked", ("B2",))):
        _check_only(f"{name} on a world of one", a[name][2], want_keys)
    print(f"world of one over NCCL: run_nmf on the staged v2 directory k={k} "
          f"maxit={M['maxit']} {dir_s:.3f} s with ingest, bit for bit phase "
          f"15's fit; ms per step world of one / no mesh: "
          + ", ".join(f"{name} {a[name][3]:.3f} / {none[name][3]:.3f}"
                      for name in a)
          + "; collective bytes per step over the fit (its one gather of H "
          "on return included): "
          + ", ".join(f"{name} {a[name][4]['bytes'] / a[name][5]:.0f}"
                      for name in a)
          + f"; every fit the bits of no mesh ({card})", flush=True)

    # (b) two gloo processes sharing the card, each on its own shards
    torch.cuda.empty_cache()
    tmp = tempfile.mkdtemp(prefix="smoke_mesh_", dir=os.path.join(ROOT,
                                                                  "build"))
    try:
        sp.save_npz(os.path.join(tmp, "G.npz"), G)
        t0 = time.perf_counter()
        procs = [subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), "--mesh-worker",
             str(r), str(M["world"]), tmp, v1], cwd=ROOT,
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
            for r in range(M["world"])]
        logs = []
        try:
            for p in procs:
                left = M["timeout"] - (time.perf_counter() - t0)
                logs.append(p.communicate(timeout=max(left, 1))[0])
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.communicate()
        world_s = time.perf_counter() - t0
        if any(p.returncode for p in procs):
            raise AssertionError(
                "the two mesh processes failed:\n" + "\n".join(
                    f"--- rank {r} (rc {p.returncode})\n{log[-6000:]}"
                    for r, (p, log) in enumerate(zip(procs, logs))))
        ranks = [dict(np.load(os.path.join(tmp, f"rank{r}.npz")))
                 for r in range(M["world"])]
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    b = {}
    for name in a:
        want = a[name][0]
        got = {f: ranks[0][f"{name}_{f}"] for f in ("w", "d", "h")}
        _mesh_gate(f"two processes {name}", got, want)
        its = [int(r[f"{name}_its"]) for r in ranks]
        if its != [a[name][5]] * M["world"]:
            raise AssertionError(f"two processes {name}: iterations {its}, "
                                 f"world of one {a[name][5]}")
        for r in ranks[1:]:
            _same_bits(f"two processes {name}: W across ranks",
                       {f: r[f"{name}_{f}"] for f in ("w", "d")},
                       {f: ranks[0][f"{name}_{f}"] for f in ("w", "d")},
                       ("w", "d"))
        b[name] = dict(
            ms=[float(r[f"{name}_ms"]) for r in ranks],
            wall_s=[float(r[f"{name}_wall_s"]) for r in ranks],
            its=its, launches=[json.loads(str(r[f"{name}_launches"]))
                               for r in ranks],
            collectives=[json.loads(str(r[f"{name}_coll"])) for r in ranks])
    gloo_cuda = json.loads(str(ranks[0]["gloo_cuda"]))
    print("two gloo processes sharing the card (not a scaling figure): "
          f"{world_s:.1f} s with start-up, staged v1 ingest of each rank's "
          f"shards {float(ranks[0]['ingest_s']):.3f} / "
          f"{float(ranks[1]['ingest_s']):.3f} s; ms per step rank 0 / 1: "
          + ", ".join(f"{name} {v['ms'][0]:.3f} / {v['ms'][1]:.3f}"
                      for name, v in b.items())
          + "; collective bytes and ms per step over the fit (rank 0; the "
          "gather of H on return and the waits for the other rank "
          "included): "
          + ", ".join(
              f"{name} {v['collectives'][0]['bytes'] / v['its'][0]:.0f} B "
              f"{v['collectives'][0]['ms'] / v['its'][0]:.3f} ms"
              for name, v in b.items())
          + f"; within rtol={FIT_RTOL} atol={FIT_ATOL} of the world of one, "
          f"equal iterations and W bits across ranks; gloo on CUDA tensors "
          f"takes {gloo_cuda} ({card})", flush=True)
    phase_s = time.perf_counter() - t_phase
    print(f"phase 17 took {phase_s:.1f} s ({card})", flush=True)
    return dict(
        phase_s=phase_s, world_s=world_s,
        one=dict(run_nmf=dict(wall_s=dir_s, launches=n_dir), **{
            name: dict(wall_s=v[1], launches=v[2], ms=v[3], collectives=v[4],
                       its=v[5], ms_no_mesh=none[name][3],
                       launches_no_mesh=none[name][2],
                       wall_s_no_mesh=none[name][1])
            for name, v in a.items()}),
        two=dict(ingest_s=[float(r["ingest_s"]) for r in ranks],
                 worker_s=[float(r["worker_s"]) for r in ranks],
                 gloo_cuda=gloo_cuda, **b))


def phase_build():
    """Build every kernel source, one nvcc each, and the C++ IO library
    (g++), all started together."""
    from singlet_tpu_torch import _build, native
    from singlet_tpu_torch.ops import bell_cuda, maskgram_cuda, nnls_cuda

    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(SOURCES) + 1) as pool:
        io_build = pool.submit(native.build)
        builds = dict(zip(SOURCES, pool.map(_build.build, SOURCES)))
        io_lib, io_s, _ = io_build.result()
    wall_s = time.perf_counter() - t0
    if not native.available():
        raise AssertionError(f"the native IO library {io_lib} did not load")
    print(f"build singlet_io.cpp (g++): {io_s:.2f} s -> "
          f"{os.path.relpath(io_lib, ROOT)}", flush=True)
    nnls_cuda._kernel()
    nnls_cuda._kernel_batched()
    nnls_cuda._kernel("nnls_wide", "nnls_wide_b1", nnls_cuda.ARGTYPES_B1_WIDE)
    bell_cuda._lib()
    bell_cuda._mse_lib()
    maskgram_cuda._m8_lib()
    maskgram_cuda._gemm_lib()
    maskgram_cuda._pairs_lib()
    for name, (lib, secs, log) in builds.items():
        print(f"build {name}.cu: {secs:.2f} s -> {os.path.relpath(lib, ROOT)}")
        # ptxas -v: registers, and (on the line after) stack and spills
        print("\n".join(ln for ln in log.splitlines()
                        if "ptxas" in ln or "spill" in ln), flush=True)
    print(f"builds took {wall_s:.2f} s together", flush=True)
    return dict({name: secs for name, (_, secs, _) in builds.items()},
                singlet_io=io_s), wall_s


def _phases(torch, card, results, ckdir):
    """Every phase after the build, in order, into ``results``; the
    resumable fits checkpoint under ``ckdir``."""
    import scipy.sparse as sp

    from singlet_tpu_torch.parallel.sharded_ell import ShardedEllEngine
    from singlet_tpu_torch.solvers.als import make_dense_providers

    A, W0 = _bench_operand()
    t0 = time.perf_counter()
    Ap, Atp = make_dense_providers(A, device="cuda")
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    results["kernel"] = phase_kernel(torch, card)
    results["kernel_b2"] = phase_kernel_b2(torch, card, Ap, Atp, W0)
    results["pairs"] = phase_pairs(torch, card)
    results["parity"] = phase_parity(torch)
    results["masked_parity"] = phase_masked_parity(torch)
    results["bench"] = phase_bench(torch, card, A, W0, Ap, Atp, setup_s)
    results["masked"] = phase_masked(torch, card, Ap, Atp, W0)
    results["resume_dense"] = phase_resume_dense(torch, card, Ap, Atp, W0,
                                                 ckdir)

    # the bench operand as scipy CSC on the ELL engine
    t0 = time.perf_counter()
    eng = ShardedEllEngine(sp.csc_matrix(A), device="cuda")
    torch.cuda.synchronize()
    results["ell_setup_s"] = time.perf_counter() - t0
    data = eng.data
    print(f"ELL ingest of the bench operand from scipy: "
          f"{results['ell_setup_s']:.3f} s, width {data.b_width} "
          f"({card})", flush=True)
    bell_rows = phase_bell_kernels(torch, card, "bench", data.b_li,
                                   data.b_val, BENCH["k"], data.gene_block,
                                   data.n_gb, 0)
    bits_rows = phase_bits_kernels(torch, card, "bench", data.b_li,
                                   data.b_val, BENCH["k"], data.gene_block,
                                   data.n_gb, 0, block=data.cell_block)
    hash_rows = phase_hash_kernels(torch, card, "bench", BENCH["k"],
                                   data.genes_pad, data.gene_block, 0,
                                   data.cells_pad, block=data.cell_block,
                                   cells_true=data.cells_true,
                                   genes_true=data.genes_true)
    # an edge geometry: 40 gene blocks (a second word group), 3 quantization
    # groups of 1000 cells for B9 (B11: 3 calls), a cell offset; for B10
    # and B11 true sizes that are no multiple of the blocks
    eli, elv, _ = synth_bell_planes_torch(1280, 3000, 400, 32)
    bits_rows += phase_bits_kernels(torch, card, "edge", eli, elv, 7, 32, 40,
                                    12345, block=1000, timed=False)
    del eli, elv
    hash_rows += phase_hash_kernels(torch, card, "edge", 7, 1280, 32, 12345,
                                    3000, block=1000,
                                    cells_true=12345 + 2990, genes_true=1270,
                                    timed=False)
    results["ell_vs_dense"] = phase_ell_vs_dense(torch, card, eng, Ap, Atp,
                                                 W0)
    results["bits_vs_f32"] = phase_bits_vs_f32(torch, card, eng, W0)
    results["wide_k"] = phase_wide_k(torch, card, data)
    results["wide_k600_bench"] = phase_wide_k600_bench(torch, card, A, Ap,
                                                       Atp, data)
    results["wide_block"] = phase_wide_block(torch, card)
    results["resume_ell_bench"] = phase_resume_ell_bench(
        torch, card, eng, W0, results["bits_vs_f32"]["int8"], ckdir)
    del A, Ap, Atp, eng, data
    results["ard"], planted, model = phase_ard(torch, card)
    results["resume_search"] = phase_resume_search(torch, card, planted,
                                                   model, ckdir)
    del planted, model
    results["large"] = phase_large(torch, card, ckdir)
    results["bell_kernels"] = bell_rows + results["large"].pop("kernels")
    results["bits_kernels"] = bits_rows + results["large"].pop(
        "bits_kernels")
    results["hash_kernels"] = hash_rows + results["large"].pop(
        "hash_kernels")
    results["ell_entry"] = phase_ell_entry(torch, card)
    # the staged directories of phase 15 under the git-ignored build/, read
    # again by phase 17, removed at the end
    stage_root = tempfile.mkdtemp(prefix="smoke_staged_",
                                  dir=os.path.join(ROOT, "build"))
    try:
        results["stream"], eng, W0, m_dir = phase_stream(torch, card,
                                                         stage_root)
        results["wide_block_stream"] = phase_wide_block_stream(
            torch, card, os.path.join(stage_root, "v2"), eng, W0)
        results["solvers"], G = phase_solvers(torch, card, eng, W0)
        results["mesh"] = phase_mesh(torch, card, stage_root, eng, W0, G,
                                     m_dir)
    finally:
        shutil.rmtree(stage_root, ignore_errors=True)
    del eng, W0, G
    # the last phase: the pipeline, its input and outputs in a temporary
    # directory under build/, removed at the end
    pipe_root = tempfile.mkdtemp(prefix="smoke_pipeline_",
                                 dir=os.path.join(ROOT, "build"))
    try:
        t0 = time.perf_counter()
        results["pipeline"] = phase_pipeline(torch, card, pipe_root)
        results["pipeline"]["phase_s"] = time.perf_counter() - t0
    finally:
        shutil.rmtree(pipe_root, ignore_errors=True)


def main(argv=None) -> int:
    import torch

    argv = sys.argv[1:] if argv is None else argv
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script "
              "needs a CUDA device", file=sys.stderr)
        return 2
    if argv[:1] == ["--mesh-worker"]:
        return mesh_worker(argv[1:])
    card = _card_line()
    print(f"torch {torch.__version__} CUDA {torch.version.cuda} "
          f"device {torch.cuda.get_device_name(0)} ({card})", flush=True)
    build_s, build_wall_s = phase_build()

    results = {"card": card, "torch": torch.__version__,
               "cuda": torch.version.cuda, "build_s": build_s,
               "build_wall_s": build_wall_s}
    # the checkpoints of the resumable fits, in the checkout's git-ignored
    # build directory, removed at the end
    os.makedirs(os.path.join(ROOT, "build"), exist_ok=True)
    ckdir = tempfile.mkdtemp(prefix="smoke_checkpoints_",
                             dir=os.path.join(ROOT, "build"))
    try:
        _phases(torch, card, results, ckdir)
    finally:
        shutil.rmtree(ckdir, ignore_errors=True)
    results["wall_s"] = time.perf_counter() - T_START

    b1_row = next(r for r in results["kernel"]
                  if (r["n"], r["k"], r["sweep_cap"]) == B1_REPORTED
                  and not r["l1_array"])
    b2_row = next(r for r in results["kernel_b2"]
                  if (r["n"], r["k"], r["sweep_cap"]) == B2_REPORTED
                  and not r.get("l1_array"))
    bell_row = {r["kernel"]: r for r in results["bell_kernels"]
                if r["shape"] == "large slice" and not r["masked"]}
    bell_row.update({r["kernel"]: r for r in results["bits_kernels"]
                     if r["shape"] == "large slice"
                     and r.get("dtype", "int8") == "int8"})
    bell_row.update({r["kernel"]: r for r in results["hash_kernels"]
                     if r["shape"] == "large slice"})
    bench, masked = results["bench"], results["masked"]
    large = results["large"]
    dense_resume = results["resume_dense"]
    ell_bench_resume, large_resume = results["resume_ell_bench"], \
        large["resume"]
    wide = results["wide_k"]
    ell_runs = [results["ell_vs_dense"]["plain_launches"],
                results["ell_vs_dense"]["masked_launches"],
                results["bits_vs_f32"]["f32"]["launches"],
                results["bits_vs_f32"]["int8"]["launches"],
                results["bits_vs_f32"]["bf16"]["launches"],
                results["bits_vs_f32"]["int8"]["mask8"]["launches"],
                results["bits_vs_f32"]["bf16"]["mask8"]["launches"],
                ell_bench_resume["launches"],
                ell_bench_resume["launches_cut"],
                ell_bench_resume["launches_resumed"],
                ell_bench_resume["launches_mask8"],
                wide["ell_fit"]["launches"], wide["ell_ard"]["launches"],
                large["plain"]["launches"], large["project"]["launches"],
                large["masked"]["launches"], large["bits"]["launches"],
                large["bits"]["mask8"]["launches"],
                large_resume["launches_first"],
                large_resume["launches_resumed"],
                large_resume["launches_full"],
                results["ell_entry"]["ard"]["launches"],
                results["ell_entry"]["cv"]["launches"]]
    # the counted runs of phases 15 and 16 (the dense ones launch B1 alone)
    stream, solvers = results["stream"], results["solvers"]
    new_runs = [stream["run_nmf"]["launches"],
                stream["run_nmf"]["launches_mono"], stream["cv"]["launches"]]
    for name in ("linked", "batch", "gcnmf", "project"):
        new_runs += [solvers["bench"][name]["launches"],
                     solvers["bench"][name]["launches_dense"]]
    new_runs += [solvers["large"][name]["launches"]
                 for name in ("batch_fit", "gcnmf_fit")]
    # phase 17: the world of one (and the same fits with no mesh) and both
    # ranks of the two processes
    mesh_res = results["mesh"]
    mesh_runs = [mesh_res["one"]["run_nmf"]["launches"]]
    for name in ("fit", "ard", "gcnmf", "dense", "dense_masked"):
        mesh_runs += [mesh_res["one"][name]["launches"],
                      mesh_res["one"][name]["launches_no_mesh"],
                      *mesh_res["two"][name]["launches"]]
    new_runs += mesh_runs
    # the wide routes' runs: run_nmf and the ELL and dense masked fits at
    # k=600, the ELL fits at a gene block of 8192; and the pipeline's
    k600, wblock = wide["k600"], results["wide_block"]
    pipe_res = results["pipeline"]
    k600b = results["wide_k600_bench"]
    wide_runs = [k600["run_nmf"]["launches"], k600["ell_ard"]["launches"],
                 k600["ell_ard"]["launches_dense"],
                 k600b["run_nmf"]["launches"], k600b["ell_step"]["launches"],
                 k600b["test_mse"]["launches"],
                 wblock["plain"]["launches"], wblock["f32"]["launches"],
                 wblock["bits"]["launches"]]
    # phase 15b's runs on the streaming operand, both gene blocks
    for run in results["wide_block_stream"].values():
        wide_runs += [run["launches"], run["step_launches"]]
    pipe_runs = [pipe_res["k10"]["launches"], pipe_res["k_list"]["launches"]]
    new_runs += wide_runs + pipe_runs
    ell_runs += new_runs
    print(f"chip_smoke total {results['wall_s']:.1f} s, the build "
          f"{build_wall_s:.1f} s of it ({card})")
    print("results: " + json.dumps(results))
    print("kernel times below: B1 at n=16384 k=50 sweep_cap=8, B2 at "
          "n=4096 k=50 sweep_cap=32; B3 and B4 unmasked, B5, B6 and B7 at "
          "k=100 on 8192 cells of the large operand (16384 genes, width "
          "32), B8 and B13 (int8) on the first 2048-cell block of them and "
          "B9 and B14 (int8) over all of them as 4 quantization groups, B12 "
          "unpacking all of them, B10 and B11 (bf16, the mask hashed) per "
          "call on one 2048-cell block of them; launches: "
          "B1 over the bench-scale nmf_fit runs, run_nmf at k=256 and the "
          "counted runs of phases 15-17 (phase 17: both ranks of the two "
          "processes), B2 over the bench-scale ard_nmf_fit, "
          "cross_validate_nmf and ard_nmf runs and phase 17's, B3-B14 over "
          "the ELL engine's counted runs, the wide routes' runs and the "
          "pipeline's; the wide routes (launches of their own runs, "
          "phase 15b's at 131072 cells included): B1 "
          "at n=2048, B2 at n=512 (packed entry), both k=600 sweep_cap=8, "
          "B7 at k=600 on the bench planes (its tiles of cells), B3 "
          "(unmasked) and B5 at k=50 on 4096 cells of 16384 genes in gene "
          "blocks of 8192 (plain_ms by slices of 256 cells); past k=2048 "
          "(launches of their one check each): B1-wide-past2048 at n=2048 "
          "and B2-wide-past2048 at n=512 (packed entry), k=2560 "
          "sweep_cap=8; B7-wide-streamed at k=1100 on the bench planes "
          "(Wd's rows streamed, max_abs_err over k=1100 and 2560); "
          "B7-wide-passes at k=600 on those gene blocks of 8192 (416 slots "
          "a cell walked in passes); bound_ms: the larger of the bytes over "
          "3.35 TB/s and the operations this run's data needs over the "
          "peak of their type (float32 67 TFLOP/s, int8 1979 TOP/s, bf16 "
          "989 TFLOP/s)")

    def entry(name, source, replaces, launches, row, err):
        return {"name": name, "route": "cuda",
                "source": f"singlet_tpu_torch/csrc/{source}",
                "replaces": f"singlet_tpu/ops/{replaces}",
                "launches": launches, "max_abs_err": err, "ms": row["ms"],
                "plain_ms": row["plain_ms"], "bound_ms": row["bound_ms"],
                "bound_by": row["bound_by"],
                "library_ms": row["library_ms"]}

    def ell_entry(name, key, source, replaces):
        rows = results["bell_kernels"] + results["bits_kernels"] + \
            results["hash_kernels"] + wide["kernels"]
        return entry(name, source, replaces,
                     sum(n[key] for n in ell_runs), bell_row[key],
                     max(r["max_abs_err"] for r in rows
                         if r["kernel"] == key))

    def pairs_entry(name, shape, side):
        # launches: those of one 524k bits step on that side (phase 11)
        row = next(r for r in results["pairs"]
                   if r["shape"] == shape and r["dtype"] == "int8")
        return {"name": name, "route": "cuda",
                "source": "singlet_tpu_torch/csrc/quantized_pairs.cu",
                "replaces": "none (XLA fused the chain, singlet_tpu/parallel/"
                            "sharded_ell.py:885-889, 997-999)",
                "launches": large["bits"]["pairs"][side][1],
                "max_abs_err": max(r["max_abs_err"] for r in results["pairs"]
                                   if r["shape"] == shape),
                "ms": row["ms"],
                "plain_ms": row["plain_ms"], "bound_ms": row["bound_ms"],
                "bound_by": row["bound_by"], "library_ms": None}

    print(json.dumps({"kernels": [
        entry("nnls_cd", "nnls_cd.cu", "pallas_nnls.py:266",
              bench["fixed10"]["launches"] + bench["race"]["launches"]
              + sum(dense_resume["nmf_fit"][key]["B1"] for key in (
                  "launches_full", "launches_resumed"))
              + wide["run_nmf"]["launches"]["B1"]
              + sum(n["B1"] for n in new_runs), b1_row,
              max(r["max_abs_err"] for r in results["kernel"]
                  + wide["kernels"] if r.get("kernel", "B1") == "B1")),
        entry("nnls_cd_batched", "nnls_cd_batched.cu", "pallas_nnls.py:195",
              masked["fit"]["launches"]["B2"] + masked["cv"]["launches"]["B2"]
              + results["ard"]["launches"]["B2"]
              + sum(dense_resume["ard_nmf_fit"][key]["B2"] for key in (
                  "launches_full", "launches_resumed"))
              + sum(n["B2"] for n in mesh_runs + wide_runs + pipe_runs),
              b2_row,
              max(r["max_abs_err"] for r in results["kernel_b2"]
                  + wide["kernels"] if r.get("kernel", "B2") == "B2")),
        ell_entry("bell_spmm", "B3", "bell_spmm.cu", "pallas_bell.py:162"),
        ell_entry("bell_spmm_t", "B4", "bell_spmm.cu", "pallas_bell.py:416"),
        ell_entry("bell_spmm_bits", "B5", "bell_spmm.cu",
                  "pallas_bell.py:260"),
        ell_entry("bell_spmm_t_bits", "B6", "bell_spmm.cu",
                  "pallas_bell.py:298"),
        ell_entry("bell_mse_bits", "B7", "bell_mse_bits.cu",
                  "pallas_bell.py:370"),
        ell_entry("mask_packed_w_t_bits", "B8", "maskgram_gemm.cu",
                  "pallas_maskgram.py:480"),
        ell_entry("mask_packed_h_t_bits", "B9", "maskgram_gemm.cu",
                  "pallas_maskgram.py:712"),
        ell_entry("mask_packed_w_t", "B10", "maskgram_gemm.cu",
                  "pallas_maskgram.py:185"),
        ell_entry("mask_packed_h_t", "B11", "maskgram_gemm.cu",
                  "pallas_maskgram.py:229"),
        ell_entry("unpack_mask_bits", "B12", "maskgram_m8.cu",
                  "maskbits.py:125"),
        ell_entry("mask_packed_w_t_m8", "B13", "maskgram_gemm.cu",
                  "pallas_maskgram.py:566"),
        ell_entry("mask_packed_h_t_m8", "B14", "maskgram_gemm.cu",
                  "pallas_maskgram.py:652"),
        entry("B1-wide", "nnls_wide.cuh", "pallas_nnls.py:266",
              sum(n["B1w"] for n in wide_runs), k600["kernels"]["B1"],
              k600["kernels"]["B1"]["max_abs_err"]),
        entry("B2-wide", "nnls_wide.cuh", "pallas_nnls.py:195",
              sum(n["B2w"] for n in wide_runs), k600["kernels"]["B2"],
              k600["kernels"]["B2"]["max_abs_err"]),
        entry("B3-wideblock", "bell_spmm.cu", "pallas_bell.py:162",
              sum(n["B3w"] for n in wide_runs), wblock["kernels"]["B3"],
              max(wblock["kernels"][key]["max_abs_err"]
                  for key in ("B3", "B3 masked"))),
        entry("B5-wideblock", "bell_spmm.cu", "pallas_bell.py:260",
              sum(n["B5w"] for n in wide_runs), wblock["kernels"]["B5"],
              wblock["kernels"]["B5"]["max_abs_err"]),
        entry("B7-wide", "bell_mse_bits.cu", "pallas_bell.py:370",
              sum(n["B7w"] for n in wide_runs), k600["kernels"]["B7"],
              k600["kernels"]["B7"]["max_abs_err"]),
        entry("B1-wide-past2048", "nnls_wide.cuh", "pallas_nnls.py:266",
              k600["kernels"]["B1 past"]["launches"]["B1w"],
              k600["kernels"]["B1 past"],
              k600["kernels"]["B1 past"]["max_abs_err"]),
        entry("B2-wide-past2048", "nnls_wide.cuh", "pallas_nnls.py:195",
              k600["kernels"]["B2 past"]["launches"]["B2w"],
              k600["kernels"]["B2 past"],
              k600["kernels"]["B2 past"]["max_abs_err"]),
        entry("B7-wide-streamed", "bell_mse_bits.cu", "pallas_bell.py:370",
              k600["kernels"][f"B7 past {B7_PAST_K}"]["launches"]["B7w"],
              k600["kernels"][f"B7 past {B7_PAST_K}"],
              max(k600["kernels"][f"B7 past {kk}"]["max_abs_err"]
                  for kk in WIDE_PAST["b7_ks"])),
        entry("B7-wide-passes", "bell_mse_bits.cu", "pallas_bell.py:370",
              wblock["kernels"]["B7 passes"]["launches"]["B7w"],
              wblock["kernels"]["B7 passes"],
              wblock["kernels"]["B7 passes"]["max_abs_err"]),
        pairs_entry("quantized_pairs", "h-side block", "h"),
        pairs_entry("quantized_pairs-wside", "w-side", "w"),
    ]}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

#!/usr/bin/env python3
"""Smoke run of ``singlet_tpu_torch`` on one CUDA card (written for an H100).

Run from the root of a checkout, with no arguments:

    python3 chip_smoke.py

Phases; any failure raises and the script exits non-zero:

0. device: torch and CUDA versions, the card's name and power limit;
1. build: compile every CUDA kernel from ``csrc/``, one nvcc per source,
   all started together;
2. kernel B1 (``ops/nnls_cuda.py``) against its plain PyTorch version on the
   card, at the half-update shapes of the bench config and at edge shapes,
   with both sweep caps the fit uses, and with a per-coordinate (n, k) L1
   at the fast cap; times both with CUDA events;
3. kernel B2 likewise, on the solve inputs of real masked half-updates
   of the bench operand (h-side and w-side blocks at k=50 and 100, the
   large config's call shapes 2048 x 100 and 16384 x 100, an edge shape),
   at the masked fast cap 32 and at 100: its packed entry (a_full and the
   packed corrections, the fits' route) the same bits as its tile entry
   on the unpacked Grams; times of both entries, of the unpack alone and
   of the plain version;
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
   (B3 and B5 launch once a call at any k);
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
   ``build/``, removed at the end.

Each counted run sets every launch counter to 0 just before it and reads
them just after. After the phases come three lines: ``results: {...}`` with
every number measured, ``{"kernels": [...]}`` and the card's name and power
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
SOURCES = ("nnls_cd", "nnls_cd_batched", "bell_spmm", "bell_mse_bits",
           "maskgram_m8", "maskgram_gemm")
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


def _median_ms(torch, fn, runs: int) -> float:
    """Median over ``runs`` of one call's device time (CUDA events)."""
    times = []
    for _ in range(runs):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


COUNTS = ("B1", "B2", "B3", "B4", "B5", "B6", "B7", "B8", "B9", "B10",
          "B11", "B12", "B13", "B14", "plain", "plain_bell", "plain_maskgram",
          "plain_maskbits")


def _launches(**nonzero):
    """A full launch-count dict: the given counts, every other one 0."""
    assert set(nonzero) <= set(COUNTS), nonzero
    return {key: nonzero.get(key, 0) for key in COUNTS}


def _counted(torch, fn):
    """Run ``fn`` with every launch counter set to 0 just before it; return
    (its result, wall seconds, the counts of COUNTS read just after: kernel
    launches of B1-B14 and calls of the plain versions)."""
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
                (maskgram, "PLAIN_CALLS"), (maskbits, "PLAIN_CALLS"))
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
    return rows


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
    if not torch.equal(Xk, Xt):
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
                         B7=5, B8=5 * blocks, B9=5)
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
                         B7=5, B12=5, B13=5 * blocks, B14=5)
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
    if not all(n_ard[key] for key in ("B2", "B5", "B6", "B7", "B8", "B9")) \
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
    return out


def phase_large(torch, card, ckdir):
    """The largescale.py operand generated on the card; the plain ELL fit,
    project, one profiled plain step, the masked ard_fit on the f32 and the
    bits route, the resumable masked fit on the hash route; and the kernel
    checks of B3-B11 on a slice of its planes."""
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
            B7=steps, B8=steps * blocks, B9=steps * blocks // F))

    def step():
        return fns["masked"](W, H, seed, 0.01, 0.01, 0.0, 0.0, k,
                             sweep_cap=float(settings.fast_masked),
                             bits=bits)

    def mse():
        return fns["mse"](W, d, H, seed, bits=bits)

    _, step_s, n_step = _counted(torch, step)
    _, mse_s, n_mse = _counted(torch, mse)
    if n_step != _launches(B2=blocks + 1, B5=blocks, B6=blocks, B8=blocks,
                           B9=blocks // F) or n_mse != _launches(B7=1):
        raise AssertionError(f"large bits step launches {n_step}, test MSE "
                             f"{n_mse}")
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
        mse_ms=mse_s * 1e3, b7_all_cells_ms=b7_ms,
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
                             B12=blocks // F, B13=blocks, B14=blocks // F),
            bits_step: _launches(B2=blocks + 1, B5=blocks, B6=blocks,
                                 B8=blocks, B9=blocks // F)}
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
                                  "B8", "B9")) \
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
    if not all(n_cv[key] for key in ("B2", "B5", "B6", "B7", "B8", "B9")) \
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
def _event_timed(torch, names):
    """Within the block, each wrapper of ``ops/bell_cuda.py`` named in
    ``names`` (its attribute name and a label) records a CUDA event before
    and after each call, on the current stream; yields a dict that, after
    the block, maps each label to [ms, calls]: the device time between the
    events, which bracket the wrapper's one kernel launch."""
    from singlet_tpu_torch.ops import bell_cuda

    spans = {label: [] for _, label in names}
    saved = {attr: getattr(bell_cuda, attr) for attr, _ in names}

    def timed(fn, label):
        def wrapper(*args, **kwargs):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            out = fn(*args, **kwargs)
            end.record()
            spans[label].append((start, end))
            return out
        return wrapper

    totals = {}
    for attr, label in names:
        setattr(bell_cuda, attr, timed(saved[attr], label))
    try:
        yield totals
    finally:
        for attr, fn in saved.items():
            setattr(bell_cuda, attr, fn)
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


def phase_build():
    """Build every kernel source, one nvcc each, started together."""
    from singlet_tpu_torch import _build
    from singlet_tpu_torch.ops import bell_cuda, maskgram_cuda, nnls_cuda

    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(SOURCES)) as pool:
        builds = dict(zip(SOURCES, pool.map(_build.build, SOURCES)))
    wall_s = time.perf_counter() - t0
    nnls_cuda._kernel()
    nnls_cuda._kernel_batched()
    bell_cuda._lib()
    bell_cuda._mse_lib()
    maskgram_cuda._m8_lib()
    maskgram_cuda._gemm_lib()
    for name, (lib, secs, log) in builds.items():
        print(f"build {name}.cu: {secs:.2f} s -> {os.path.relpath(lib, ROOT)}")
        # ptxas -v: registers, and (on the line after) stack and spills
        print("\n".join(ln for ln in log.splitlines()
                        if "ptxas" in ln or "spill" in ln), flush=True)
    print(f"builds took {wall_s:.2f} s together", flush=True)
    return {name: secs for name, (_, secs, _) in builds.items()}, wall_s


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


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script "
              "needs a CUDA device", file=sys.stderr)
        return 2
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
                  if (r["n"], r["k"], r["sweep_cap"]) == B2_REPORTED)
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
    print("results: " + json.dumps(results))
    print("kernel times below: B1 at n=16384 k=50 sweep_cap=8, B2 at "
          "n=4096 k=50 sweep_cap=32; B3 and B4 unmasked, B5, B6 and B7 at "
          "k=100 on 8192 cells of the large operand (16384 genes, width "
          "32), B8 and B13 (int8) on the first 2048-cell block of them and "
          "B9 and B14 (int8) over all of them as 4 quantization groups, B12 "
          "unpacking all of them, B10 and B11 (bf16, the mask hashed) per "
          "call on one 2048-cell block of them; launches: "
          "B1 over the bench-scale nmf_fit runs and run_nmf at k=256, B2 "
          "over the bench-scale "
          "ard_nmf_fit, cross_validate_nmf and ard_nmf runs, B3-B14 over the "
          "ELL engine's counted runs; bound_ms: the larger of the bytes over "
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

    print(json.dumps({"kernels": [
        entry("nnls_cd", "nnls_cd.cu", "pallas_nnls.py:266",
              bench["fixed10"]["launches"] + bench["race"]["launches"]
              + sum(dense_resume["nmf_fit"][key]["B1"] for key in (
                  "launches_full", "launches_resumed"))
              + wide["run_nmf"]["launches"]["B1"], b1_row,
              max(r["max_abs_err"] for r in results["kernel"]
                  + wide["kernels"] if r.get("kernel", "B1") == "B1")),
        entry("nnls_cd_batched", "nnls_cd_batched.cu", "pallas_nnls.py:195",
              masked["fit"]["launches"]["B2"] + masked["cv"]["launches"]["B2"]
              + results["ard"]["launches"]["B2"]
              + sum(dense_resume["ard_nmf_fit"][key]["B2"] for key in (
                  "launches_full", "launches_resumed")), b2_row,
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
    ]}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

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
   with both sweep caps the fit uses; times both with CUDA events;
3. kernel B2 likewise, on the per-column Grams of real masked half-updates
   of the bench operand (h-side and w-side blocks, k=50 and 100, an edge
   shape), at the masked fast cap 32 and at 100;
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
   the same bits on a second run, an exact 0/1 case; times of both;
10. the ELL engine against the dense providers on the bench operand from
   one W0: 5 plain iterations and a 5-iteration masked ``ard_fit`` (equal
   ``iter`` lists), within the fit tolerance;
11. the large operand of benchmarks/largescale.py generated on the card
   (524,288 cells x 16,384 genes, 824 nonzeros per cell, k=100): the plain
   ELL fit for 10 iterations at tol=0 (ms per iteration, cells/s, B1, B3
   and B4 launches, no plain call), ``project`` of all cells, one plain
   step under torch.profiler, then the masked ``ard_fit`` for 2 traced
   iterations, and one masked step and one test MSE under the profiler;
12. the user's entry points on the ELL route: the planted rank-10 operand
   as scipy CSC (past 64e6 entries), ``ard_nmf`` (10 +- 2) and
   ``cross_validate_nmf`` at ranks 5, 10 and 20.

Each counted run sets every launch counter to 0 just before it and reads
them just after. After the phases come three lines: ``results: {...}`` with
every number measured, ``{"kernels": [...]}`` and the card's name and power
limit; the last line is ``{"ok": true, "device": {...}}``. Without a CUDA
device the script exits 2 and prints no result.
"""

from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys
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
# kernel B2: the h-side block (2048 cells) and w-side block (4096 genes) of
# the bench config, k=100, and a width that is no multiple of 32
B2_SHAPES = [(2048, 50), (4096, 50), (4096, 100), (1500, 10)]
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
SOURCES = ("nnls_cd", "nnls_cd_batched", "bell_spmm")
# kernels B3 and B4 against their plain versions: only the order of the
# sums differs
BELL_TOL = 1e-5
# benchmarks/largescale.py: cells x genes, nonzeros per cell, k; width 32
LARGE = dict(genes=16384, cells=524288, nnz=824, k=100, maxit=10,
             masked_maxit=2, gene_block=512, cell_block=2048)
# the large operand's slice for the kernel checks: 4 cell blocks of 2048
# at full gene width, at a cell offset inside the operand
LARGE_SLICE = (262144, 4 * 2048)


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


def _counted(torch, fn):
    """Run ``fn`` with every launch counter set to 0 just before it; return
    (its result, wall seconds, {B1, B2, B3, B4, plain, plain_bell} counts
    read just after)."""
    from singlet_tpu_torch.ops import bell, bell_cuda, nnls, nnls_cuda

    nnls_cuda.LAUNCHES = 0
    nnls_cuda.LAUNCHES_BATCHED = 0
    bell_cuda.LAUNCHES_SPMM = 0
    bell_cuda.LAUNCHES_SPMM_T = 0
    nnls.PLAIN_CALLS = 0
    bell.PLAIN_CALLS = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    return out, secs, {"B1": nnls_cuda.LAUNCHES,
                       "B2": nnls_cuda.LAUNCHES_BATCHED,
                       "B3": bell_cuda.LAUNCHES_SPMM,
                       "B4": bell_cuda.LAUNCHES_SPMM_T,
                       "plain": nnls.PLAIN_CALLS,
                       "plain_bell": bell.PLAIN_CALLS}


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


def phase_kernel(torch, card):
    from singlet_tpu_torch.ops import nnls
    from singlet_tpu_torch.ops.nnls_cuda import nnls_batch_cuda

    rows = []
    for n, k in KERNEL_SHAPES:
        a, B, X0, mask = _nnls_problem(torch, n, k, seed=n + k)
        for cap in SWEEP_CAPS:
            kw = dict(L1=0.01, L2=0.001, update_mask=mask,
                      sweep_cap=float(cap))
            Xk = nnls_batch_cuda(a, B, X0, **kw)
            Xp = nnls.nnls_batch(a, B, X0, **kw)
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
            rows.append(dict(n=n, k=k, sweep_cap=cap, max_abs_err=err,
                             ms=ms, plain_ms=plain_ms))
            print(f"kernel B1 n={n} k={k} cap={cap}: max|err|={err:.3e} "
                  f"kernel {ms:.4f} ms, plain {plain_ms:.3f} ms "
                  f"({card})", flush=True)
    return rows


def _masked_solve_inputs(torch, P, X, n, seed):
    """The solve inputs of a real masked half-update of the first ``n``
    columns of provider ``P`` against factor ``X``: per-column Grams
    ``a_full - unpack(packed_t)`` in B2's (k, k, n) layout and B from the
    kept entries; a warm X0 with zeros, 5% of the columns masked out."""
    from singlet_tpu_torch.ops import linalg
    from singlet_tpu_torch.ops.rngmask import seed_pair

    k = X.shape[1]
    iu = linalg.triu_pairs(k)
    m = P.mask_tile(seed_pair(MASKED["mask_seed"]), 0, n,
                    MASKED["inv_density"])
    B = torch.where(m, 0.0, P.col_block(0, n).T) @ X
    packed_t = linalg.mask_dot_t(linalg.packed_outer_products(X, iu), m, 1)
    at = linalg.unpack_sym_from_t(packed_t, k, iu, linalg.gram(X))
    rng = np.random.default_rng(seed)
    X0 = (rng.random((n, k)) * (rng.random((n, k)) < 0.5)).astype(np.float32)
    mask = rng.random(n) >= 0.05
    dev = X.device
    return at, B, torch.as_tensor(X0, device=dev), \
        torch.as_tensor(mask, device=dev)


def phase_kernel_b2(torch, card, Ap, Atp, W0):
    from singlet_tpu_torch.ops import nnls
    from singlet_tpu_torch.ops.nnls_cuda import nnls_batch_cuda_batched_at

    # factors as wide as the widest shape: W0, then U(0, 1) columns
    k_top = max(k for _, k in B2_SHAPES)
    rng = np.random.default_rng(5)
    H0 = torch.as_tensor(rng.random((Ap.cols_pad, k_top), dtype=np.float32),
                         device="cuda")
    W = np.zeros((Ap.rows_pad, k_top), np.float32)
    W[: W0.shape[0]] = np.concatenate(
        [W0, rng.random((W0.shape[0], k_top - W0.shape[1]),
                        dtype=np.float32)], axis=1)
    W = torch.as_tensor(W, device="cuda")
    rows = []
    for n, k in B2_SHAPES:
        # a w-side block solves genes against H, the others cells against W
        P, X = (Atp, H0[:, :k]) if n == Atp.block else (Ap, W[:, :k])
        at, B, X0, mask = _masked_solve_inputs(torch, P, X.contiguous(), n,
                                               seed=n + k)
        for cap in B2_SWEEP_CAPS:
            kw = dict(L1=0.01, L2=0.001, update_mask=mask,
                      sweep_cap=float(cap))
            Xk = nnls_batch_cuda_batched_at(at, B, X0, **kw)
            Xp = nnls.nnls_batch(at.permute(2, 1, 0), B, X0, **kw)
            torch.cuda.synchronize()
            np.testing.assert_allclose(Xk.cpu().numpy(), Xp.cpu().numpy(),
                                       rtol=KERNEL_RTOL, atol=KERNEL_ATOL)
            if not torch.equal(Xk[~mask], X0[~mask]):
                raise AssertionError(f"B2: masked rows differ from X0 at "
                                     f"n={n} k={k} cap={cap}")
            err = float((Xk - Xp).abs().max())
            ms = _median_ms(torch, lambda: nnls_batch_cuda_batched_at(
                at, B, X0, **kw), runs=10)
            plain_ms = _median_ms(torch, lambda: nnls.nnls_batch(
                at.permute(2, 1, 0), B, X0, **kw), runs=2)
            rows.append(dict(n=n, k=k, sweep_cap=cap, max_abs_err=err,
                             ms=ms, plain_ms=plain_ms))
            print(f"kernel B2 n={n} k={k} cap={cap}: max|err|={err:.3e} "
                  f"kernel {ms:.4f} ms, plain {plain_ms:.3f} ms "
                  f"({card})", flush=True)
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
                cv_rows=len(model.cv_data))


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
            rows.append(dict(shape=label, kernel=name, masked=masked,
                             cells=cells, k=k, width=width,
                             max_abs_err=err, max_abs_out=scale, ms=ms,
                             plain_ms=plain_ms))
            print(f"kernel {name} {label} cells={cells} k={k} width={width} "
                  f"masked={masked}: max|err|={err:.3e} (max|out| "
                  f"{scale:.3e}), same bits twice, kernel {ms:.4f} ms, "
                  f"plain {plain_ms:.3f} ms ({card})", flush=True)

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


def phase_ell_vs_dense(torch, card, eng, Ap, Atp, W0):
    """The ELL engine (the bench operand given as scipy) against the dense
    providers (given as numpy) from one W0: 5 plain iterations and a
    5-iteration masked ard_fit, within the fit tolerance."""
    import singlet_tpu_torch as stt

    k = BENCH["k"]
    res_e, secs_e, n_e = _counted(torch, lambda: eng.fit(
        k, w_init=W0, tol=0.0, maxit=5))
    res_d = stt.nmf_fit(Ap, k, At=Atp, w_init=W0, tol=0.0, maxit=5)
    want = {"B1": 10, "B2": 0, "B3": 5, "B4": 5, "plain": 0, "plain_bell": 0}
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
    r_e, secs_m, n_m = _counted(torch, lambda: eng.ard_fit(k, **fit_kw))
    r_d = stt.ard_nmf_fit(Ap, k, At=Atp, **fit_kw)
    blocks = eng.data.cells_pad // eng.data.cell_block
    want = {"B1": 0, "B2": 5 * (blocks + 1), "B3": 5 * blocks,
            "B4": 5 * blocks, "plain": 0, "plain_bell": 0}
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
          f"masked ard_fit in {secs_m:.3f} s on the ELL engine agree with the "
          f"dense providers within rtol={FIT_RTOL} atol={FIT_ATOL}; iter "
          f"{r_e.iter}; test mse {r_e.test_mse} ({card})", flush=True)
    return dict(plain_s=secs_e, plain_launches=n_e, masked_s=secs_m,
                masked_launches=n_m, iter=r_e.iter,
                test_mse_ell=r_e.test_mse, test_mse_dense=r_d.test_mse,
                tol_trace_ell=res_e["tol_trace"],
                tol_trace_dense=res_d.tol_trace)


def phase_large(torch, card):
    """The largescale.py operand generated on the card; the plain ELL fit,
    project, one profiled plain step, the masked ard_fit; and the kernel
    checks of B3/B4 on a slice of its planes."""
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

    torch.cuda.reset_peak_memory_stats()
    res, secs, n_fit = _counted(torch, lambda: eng.fit(
        k, tol=0.0, maxit=L["maxit"], seed=0))
    iters = len(res["tol_trace"])
    want = {"B1": 2 * iters, "B2": 0, "B3": iters, "B4": iters, "plain": 0,
            "plain_bell": 0}
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
            or n_proj["B3"] != 1 or n_proj["B1"] != 1 \
            or n_proj["plain"] or n_proj["plain_bell"]:
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
        label=f"large plain ELL step (sweep cap {settings.fast})")

    torch.cuda.reset_peak_memory_stats()
    r, msecs, n_m = _counted(torch, lambda: eng.ard_fit(
        k, maxit=L["masked_maxit"], tol=0.0, trace_test_mse=1,
        overfit_threshold=1.0, mask_seed=MASKED["mask_seed"],
        inv_density=MASKED["inv_density"]))
    steps = len(r.iter)
    blocks = cells // L["cell_block"]
    want = {"B1": 0, "B2": steps * (blocks + 1), "B3": steps * blocks,
            "B4": steps * blocks, "plain": 0, "plain_bell": 0}
    if steps != L["masked_maxit"] or n_m != want:
        raise AssertionError(f"large masked fit: {steps} steps, launches "
                             f"{n_m}; want {want}")
    if not (np.isfinite(r.test_mse).all() and min(r.test_mse) > 0):
        raise AssertionError(f"large masked fit: test mse {r.test_mse}")
    _check_fit(r.w, r.d, r.h, (genes, k), (k, cells))
    mpeak = torch.cuda.max_memory_allocated() / 2**30
    print(f"large masked ELL ard_fit k={k} {steps} iterations, each traced: "
          f"{msecs:.3f} s, {msecs * 1e3 / steps:.1f} ms per masked iteration "
          f"with its test MSE, launches {n_m}, test mse {r.test_mse}, peak "
          f"{mpeak:.2f} GiB ({card})", flush=True)
    # one masked step at the masked fast-phase cap and one test MSE, each
    # under the profiler, from the masked fit's factors
    seed = seed_pair(MASKED["mask_seed"])
    W = torch.as_tensor(r.w, device="cuda")
    H = torch.as_tensor(r.h.T.copy(), device="cuda")
    d = torch.as_tensor(r.d, device="cuda")
    masked_profile = _profile(torch, card, lambda: fns["masked"](
        W, H, seed, 0.01, 0.01, 0.0, 0.0, k,
        sweep_cap=float(settings.fast_masked)),
        label=f"large masked ELL step (sweep cap {settings.fast_masked})")
    mse_profile = _profile(torch, card, lambda: fns["mse"](W, d, H, seed),
                           label="large test MSE")
    return dict(
        genes=genes, cells=cells, nnz=nnz, width=width, k=k,
        gen_s=gen_s, planes_gib=planes_gib, kernels=kernel_rows,
        plain=dict(iters=iters, wall_s=secs, ms_per_iter=ms_it,
                   cells_per_s=cells * 1e3 / ms_it, launches=n_fit,
                   final_tol=res["tol_trace"][-1], peak_mem_gib=peak),
        project=dict(wall_s=proj_s, launches=n_proj), profile=profile,
        masked=dict(steps=steps, wall_s=msecs,
                    ms_per_iter=msecs * 1e3 / steps, launches=n_m,
                    test_mse=r.test_mse, peak_mem_gib=mpeak,
                    profile=masked_profile, mse_profile=mse_profile))


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
    if not (n["B1"] and n["B2"] and n["B3"] and n["B4"]) or n["plain"] \
            or n["plain_bell"]:
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
    if not (n_cv["B2"] and n_cv["B3"] and n_cv["B4"]) or n_cv["B1"] \
            or n_cv["plain"] or n_cv["plain_bell"]:
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


def _profile(torch, card, fn, label="race"):
    """Device time by kernel over one run of ``fn`` (torch.profiler), and
    the device's idle share of the run's wall time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 acc_events=True) as prof:
        # the trace can miss the first kernel launched in its window (kernel
        # B3, when ``fn`` starts with it): launch a tiny one before the
        # timed run
        torch.ones(1, device="cuda").add_(1)
        torch.cuda.synchronize()
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
    return dict(wall_ms=wall_us / 1e3, busy_ms=busy_us / 1e3,
                kernels_ms={name: us / 1e3 for name, us in top})


def phase_build():
    """Build every kernel source, one nvcc each, started together."""
    from singlet_tpu_torch import _build
    from singlet_tpu_torch.ops import bell_cuda, nnls_cuda

    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(SOURCES)) as pool:
        builds = dict(zip(SOURCES, pool.map(_build.build, SOURCES)))
    wall_s = time.perf_counter() - t0
    nnls_cuda._kernel()
    nnls_cuda._kernel_batched()
    bell_cuda._lib()
    for name, (lib, secs, log) in builds.items():
        print(f"build {name}.cu: {secs:.2f} s -> {os.path.relpath(lib, ROOT)}")
        print("\n".join(ln for ln in log.splitlines() if "ptxas" in ln),
              flush=True)
    print(f"builds took {wall_s:.2f} s together", flush=True)
    return {name: secs for name, (_, secs, _) in builds.items()}, wall_s


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script "
              "needs a CUDA device", file=sys.stderr)
        return 2
    import scipy.sparse as sp

    from singlet_tpu_torch.parallel.sharded_ell import ShardedEllEngine
    from singlet_tpu_torch.solvers.als import make_dense_providers

    card = _card_line()
    print(f"torch {torch.__version__} CUDA {torch.version.cuda} "
          f"device {torch.cuda.get_device_name(0)} ({card})", flush=True)
    build_s, build_wall_s = phase_build()

    results = {"card": card, "torch": torch.__version__,
               "cuda": torch.version.cuda, "build_s": build_s,
               "build_wall_s": build_wall_s}
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

    # the bench operand as scipy CSC on the ELL engine
    t0 = time.perf_counter()
    eng = ShardedEllEngine(sp.csc_matrix(A), device="cuda")
    torch.cuda.synchronize()
    results["ell_setup_s"] = time.perf_counter() - t0
    print(f"ELL ingest of the bench operand from scipy: "
          f"{results['ell_setup_s']:.3f} s, width {eng.data.b_width} "
          f"({card})", flush=True)
    bell_rows = phase_bell_kernels(torch, card, "bench", eng.data.b_li,
                                   eng.data.b_val, BENCH["k"],
                                   eng.data.gene_block, eng.data.n_gb, 0)
    results["ell_vs_dense"] = phase_ell_vs_dense(torch, card, eng, Ap, Atp,
                                                 W0)
    del A, Ap, Atp, eng
    results["ard"] = phase_ard(torch, card)
    results["large"] = phase_large(torch, card)
    results["bell_kernels"] = bell_rows + results["large"].pop("kernels")
    results["ell_entry"] = phase_ell_entry(torch, card)
    results["wall_s"] = time.perf_counter() - T_START

    b1_row = next(r for r in results["kernel"]
                  if (r["n"], r["k"], r["sweep_cap"]) == B1_REPORTED)
    b2_row = next(r for r in results["kernel_b2"]
                  if (r["n"], r["k"], r["sweep_cap"]) == B2_REPORTED)
    bell_row = {r["kernel"]: r for r in results["bell_kernels"]
                if r["shape"] == "large slice" and not r["masked"]}
    bench, masked = results["bench"], results["masked"]
    ell_runs = [results["ell_vs_dense"]["plain_launches"],
                results["ell_vs_dense"]["masked_launches"],
                results["large"]["plain"]["launches"],
                results["large"]["project"]["launches"],
                results["large"]["masked"]["launches"],
                results["ell_entry"]["ard"]["launches"],
                results["ell_entry"]["cv"]["launches"]]
    print("results: " + json.dumps(results))
    print("kernel times below: B1 at n=16384 k=50 sweep_cap=8, B2 at "
          "n=4096 k=50 sweep_cap=32, B3 and B4 unmasked at k=100 on 8192 "
          "cells of the large operand (16384 genes, width 32); launches: B1 "
          "over the two bench-scale nmf_fit runs, B2 over the bench-scale "
          "ard_nmf_fit, cross_validate_nmf and ard_nmf runs, B3 and B4 over "
          "the ELL engine's counted runs")
    print(json.dumps({"kernels": [{
        "name": "nnls_cd_shared",
        "route": "cuda",
        "source": "singlet_tpu_torch/csrc/nnls_cd.cu",
        "replaces": "singlet_tpu/ops/pallas_nnls.py:266",
        "launches": bench["fixed10"]["launches"] + bench["race"]["launches"],
        "max_abs_err": max(r["max_abs_err"] for r in results["kernel"]),
        "ms": b1_row["ms"],
        "plain_ms": b1_row["plain_ms"],
    }, {
        "name": "nnls_cd_batched",
        "route": "cuda",
        "source": "singlet_tpu_torch/csrc/nnls_cd_batched.cu",
        "replaces": "singlet_tpu/ops/pallas_nnls.py:195",
        "launches": (masked["fit"]["launches"]["B2"]
                     + masked["cv"]["launches"]["B2"]
                     + results["ard"]["launches"]["B2"]),
        "max_abs_err": max(r["max_abs_err"] for r in results["kernel_b2"]),
        "ms": b2_row["ms"],
        "plain_ms": b2_row["plain_ms"],
    }] + [{
        "name": name,
        "route": "cuda",
        "source": "singlet_tpu_torch/csrc/bell_spmm.cu",
        "replaces": f"singlet_tpu/ops/pallas_bell.py:{line}",
        "launches": sum(n[key] for n in ell_runs),
        "max_abs_err": max(r["max_abs_err"] for r in results["bell_kernels"]
                           if r["kernel"] == key),
        "ms": bell_row[key]["ms"],
        "plain_ms": bell_row[key]["plain_ms"],
    } for name, key, line in (("bell_spmm", "B3", 162),
                              ("bell_spmm_t", "B4", 416))]}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

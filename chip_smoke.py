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
   bench shape: it must select the planted rank within 2.

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
SOURCES = ("nnls_cd", "nnls_cd_batched")


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
    (its result, wall seconds, {B1, B2, plain} counts read just after)."""
    from singlet_tpu_torch.ops import nnls, nnls_cuda

    nnls_cuda.LAUNCHES = 0
    nnls_cuda.LAUNCHES_BATCHED = 0
    nnls.PLAIN_CALLS = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    return out, secs, {"B1": nnls_cuda.LAUNCHES,
                       "B2": nnls_cuda.LAUNCHES_BATCHED,
                       "plain": nnls.PLAIN_CALLS}


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


def _profile(torch, card, fn, label="race"):
    """Device time by kernel over one run of ``fn`` (torch.profiler), and
    the device's idle share of the run's wall time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 acc_events=True) as prof:
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
    from singlet_tpu_torch.ops import nnls_cuda

    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(SOURCES)) as pool:
        builds = dict(zip(SOURCES, pool.map(_build.build, SOURCES)))
    wall_s = time.perf_counter() - t0
    nnls_cuda._kernel()
    nnls_cuda._kernel_batched()
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
    del A, Ap, Atp
    results["ard"] = phase_ard(torch, card)

    b1_row = next(r for r in results["kernel"]
                  if (r["n"], r["k"], r["sweep_cap"]) == B1_REPORTED)
    b2_row = next(r for r in results["kernel_b2"]
                  if (r["n"], r["k"], r["sweep_cap"]) == B2_REPORTED)
    bench, masked = results["bench"], results["masked"]
    print("results: " + json.dumps(results))
    print("kernel times below: B1 at n=16384 k=50 sweep_cap=8, B2 at "
          "n=4096 k=50 sweep_cap=32; launches: B1 over the two bench-scale "
          "nmf_fit runs, B2 over the bench-scale ard_nmf_fit, "
          "cross_validate_nmf and ard_nmf runs")
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
    }]}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

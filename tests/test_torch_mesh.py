"""The port's fits on a mesh of ranks (``singlet_tpu_torch/parallel/``)
against the JAX package's on ``make_mesh(n)`` of the same size, on the CPU.

Each world of 2 or 4 ranks runs as gloo subprocesses of this file
(``python tests/test_torch_mesh.py --worker fits <n> <rank> <dir>``),
joined through a ``FileStore`` in ``tmp_path``: one world of each size runs
every fit once and writes one ``.npz`` per rank, and the tests compare
those with the JAX fits on ``make_mesh(n)`` of ``tests/conftest.py``'s 8
virtual devices. JAX is imported only inside the test functions, so the
workers never import it. A world that does not end within 120 s fails its
tests with the workers' output.

The operands are tiny and shared by seed: a 48 x 600 sparse matrix (at 4
ranks, blocks of 256 cells, so rank 3 holds padding only) and a 50 x 600
dense one. Tolerances: the dense mesh engine at those of
tests/test_sharded.py (plain rtol 2e-4, atol 2e-5; masked rtol 5e-4,
atol 5e-5, test MSE rtol 1e-3); the ELL engine's fits at those of
tests/test_torch_sharded_ell.py (rtol 5e-3, atol 5e-4, test MSE rtol 5e-3,
equal ``iter`` lists); the drivers at those of tests/test_mesh_drivers.py
and tests/test_torch_ell_drivers.py (run_nmf rtol 3e-4, atol 3e-5; the CV
frames as tests/test_torch_masked.py compares them). gloo and JAX's psum
add the ranks in another order, so nothing here is bit for bit across the
packages; every rank of a world returns the same model bits.
"""

import functools
import os
import subprocess
import sys
import time

import numpy as np
import pytest
import scipy.sparse as sp

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
WORLD_TIMEOUT = 120

FIT = dict(rtol=5e-3, atol=5e-4)
DENSE_PLAIN = dict(rtol=2e-4, atol=2e-5)
DENSE_MASKED = dict(rtol=5e-4, atol=5e-5)
RUN_NMF = dict(rtol=3e-4, atol=3e-5)
K = 3
ELL_BLOCKS = dict(cell_block=256, gene_block=32)
CV = dict(ranks=[2, 3], n_replicates=1, maxit=3, verbose=0,
          trace_test_mse=1, test_density=0.1, seed=4)
ARD = dict(k_max=5, maxit=3, verbose=0, trace_test_mse=1, test_density=0.1,
           max_fits=4, seed=2)


# ------------------------------------------------------------ the worlds

class World:
    """``n`` gloo ranks of ``script --worker scenario`` under one FileStore
    in ``tmp_path``, started at once; ``results()`` waits for them and
    returns each rank's ``.npz`` as a dict. A world past WORLD_TIMEOUT
    seconds from its start, or a rank that fails, fails the test with
    every rank's output."""

    def __init__(self, tmp_path, script: str, scenario: str, n: int, *args):
        self.name = f"world {scenario} of {n} ranks"
        self.out = os.path.join(str(tmp_path), f"{scenario}_{n}")
        os.makedirs(self.out, exist_ok=True)
        env = dict(os.environ, OMP_NUM_THREADS="1",
                   PYTHONPATH=os.pathsep.join(
                       [ROOT, HERE, os.environ.get("PYTHONPATH", "")]))
        self.t0 = time.monotonic()
        self.procs = [subprocess.Popen(
            [sys.executable, script, "--worker", scenario, str(n), str(r),
             self.out, *map(str, args)],
            env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True) for r in range(n)]
        self._results = None

    def results(self):
        if self._results is not None:
            return self._results
        logs = []
        try:
            for p in self.procs:
                left = WORLD_TIMEOUT - (time.monotonic() - self.t0)
                logs.append(p.communicate(timeout=max(left, 1))[0])
        except subprocess.TimeoutExpired:
            for p in self.procs:
                p.kill()
            logs = [p.communicate()[0] for p in self.procs]
            pytest.fail(f"{self.name} passed {WORLD_TIMEOUT} s:\n"
                        + "\n".join(f"--- rank {r}\n{log}"
                                    for r, log in enumerate(logs)))
        if any(p.returncode for p in self.procs):
            pytest.fail(f"{self.name} failed:\n" + "\n".join(
                f"--- rank {r} (rc {p.returncode})\n{log}"
                for r, (p, log) in enumerate(zip(self.procs, logs))))
        self._results = [dict(np.load(
            os.path.join(self.out, f"rank{r}.npz"), allow_pickle=False))
            for r in range(len(self.procs))]
        return self._results

    def stop(self) -> None:
        for p in self.procs:
            if p.poll() is None:
                p.kill()
                p.communicate()


def worker_main(scenarios) -> None:
    """``--worker <scenario> <n> <rank> <dir> [args]``: join the world of
    ``n`` gloo ranks through ``<dir>/store``, run the scenario on a "cells"
    mesh of the CPU and save its dict of arrays as ``<dir>/rank<r>.npz``."""
    import torch

    torch.set_num_threads(1)
    import singlet_tpu_torch as stt

    scenario, n, rank, out = sys.argv[2], int(sys.argv[3]), \
        int(sys.argv[4]), sys.argv[5]
    stt.initialize(coordinator_address="file://" + os.path.join(out,
                                                                "store"),
                   num_processes=n, process_id=rank, device="cpu")
    mesh = stt.make_mesh(n, device="cpu")
    res = scenarios[scenario](mesh, out, *sys.argv[6:])
    np.savez(os.path.join(out, f"rank{rank}.npz"), **res)
    import torch.distributed as dist

    dist.destroy_process_group()


# ------------------------------------------------------------ operands

def ell_operand():
    A = sp.random(48, 600, density=0.2, random_state=11, dtype=np.float32,
                  format="csc")
    A.data = np.abs(A.data) + 0.1
    return A


def dense_operand():
    rng = np.random.default_rng(5)
    A = rng.random((50, 4)) @ rng.random((4, 600))
    A[rng.random(A.shape) < 0.5] = 0
    return A.astype(np.float32)


def w0_of(genes: int, k: int = K, seed: int = 1) -> np.ndarray:
    return np.random.default_rng(seed).random((genes, k)).astype(np.float32)


def ring(n: int):
    """A sparse row-normalized ring graph over n cells."""
    return sp.diags([np.ones(n - 1), np.ones(n), np.ones(n - 1)],
                    [-1, 0, 1], format="csc").astype(np.float32) / 3.0


def link_h_of(cells: int) -> np.ndarray:
    link = np.ones((cells, K), np.float32)
    link[: cells // 2, 2] = 0.0
    return link


def batch_of(cells: int) -> np.ndarray:
    return np.arange(cells) % 3


def draw_init(k, genes_pad, genes_true, seed):
    """The drivers' W init in both packages: numpy from the seed, zero on
    padded rows (tests/test_torch_masked.py ``_shared_init_w``)."""
    w = np.random.default_rng(seed).random((genes_pad, k))
    w[genes_true:] = 0.0
    return w.astype(np.float32)


def _frame(prefix, df) -> dict:
    return {f"{prefix}_{c}": df[c].to_numpy() for c in df.columns}


def fits(mesh, out):
    """Every fit of this file on the mesh: the rank's dict of results."""
    import torch

    import singlet_tpu_torch as stt
    from singlet_tpu_torch.solvers import drivers as tdrivers

    A, D = ell_operand(), dense_operand()
    w0 = w0_of(A.shape[0])
    res = {}
    for masked in (False, True):
        r = stt.sharded_nmf_fit(D, K, mesh=mesh, tol=0.0, maxit=4,
                                w_init=w0_of(D.shape[0]), masked=masked,
                                device="cpu")
        key = "dense_masked" if masked else "dense_plain"
        res.update({f"{key}_{f}": np.asarray(r[f]) for f in
                    ("w", "d", "h", "tol_trace")})
        if masked:
            res[f"{key}_test_mse"] = np.asarray(r["test_mse"])
    eng = stt.ShardedEllEngine(A, mesh=mesh, device="cpu", **ELL_BLOCKS)
    for name, kw in (("plain", {}), ("masked", dict(masked=True))):
        r = eng.fit(K, tol=0.0, maxit=4, w_init=w0, **kw)
        res.update({f"{name}_{f}": np.asarray(v) for f, v in r.items()})
    a = eng.ard_fit(K, w_init=w0, maxit=6, tol=1e-4, mask_seed=2)
    res.update({f"ard_{f}": np.asarray(getattr(a, f)) for f in
                ("w", "d", "h", "test_mse", "iter", "tol", "score_overfit")})
    r = eng.fit(K, tol=0.0, maxit=4, w_init=w0, link_h=link_h_of(600))
    res.update({f"linked_{f}": np.asarray(r[f]) for f in ("w", "d", "h")})
    h, d = eng.project(w0)
    res.update(project_h=h, project_d=d)
    r = eng.batch_fit(batch_of(600), K, tol=0.0, maxit=4, w_init=w0)
    res.update({f"batch_{f}": np.asarray(r[f]) for f in ("w", "d", "h")})
    r = eng.gcnmf_fit(ring(600), K, tol=0.0, maxit=4, w_init=w0)
    res.update({f"gcnmf_{f}": np.asarray(r[f]) for f in ("w", "d", "h")})

    m = stt.run_nmf(A, rank=4, w_init=w0_of(48, 4), tol=0.0, maxit=4,
                    mesh=mesh, device="cpu")
    res.update(run_nmf_w=m.w, run_nmf_d=m.d, run_nmf_h=m.h)
    tdrivers.init_w = lambda k, gp, gt, seed, device=None: \
        torch.as_tensor(draw_init(k, gp, gt, seed), device=device)
    res.update(_frame("cv", stt.cross_validate_nmf(A, mesh=mesh,
                                                   device="cpu", **CV)))
    m = stt.ard_nmf(A, mesh=mesh, device="cpu", **ARD)
    res.update(_frame("ard_nmf", m.cv_data))
    res.update(ard_nmf_w=m.w, ard_nmf_k=np.asarray(m.w.shape[1]))
    return res


@pytest.fixture(scope="module")
def _worlds(tmp_path_factory):
    """Both worlds of this file, started together."""
    tmp = tmp_path_factory.mktemp("fits")
    worlds = {n: World(tmp, __file__, "fits", n) for n in (2, 4)}
    yield worlds
    for w in worlds.values():
        w.stop()


@pytest.fixture(scope="module", params=[2, 4], ids=["world2", "world4"])
def world(request, _worlds):
    return request.param, _worlds[request.param].results()


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    import torch

    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@functools.lru_cache(maxsize=None)
def _jax_engine(n):
    """The JAX engine of ``ell_operand()`` on ``make_mesh(n)``, built once
    so that its compiled programs serve every test."""
    from singlet_tpu.parallel import sharded_ell as jell
    from singlet_tpu.parallel.sharded import make_mesh

    return jell.ShardedEllEngine(ell_operand(), mesh=make_mesh(n),
                                 **ELL_BLOCKS)


def _close(got: dict, prefix: str, want, tol, fields=("w", "d", "h")):
    for f in fields:
        w = want[f] if isinstance(want, dict) else getattr(want, f)
        np.testing.assert_allclose(got[f"{prefix}_{f}"], np.asarray(w),
                                   **tol, err_msg=f"{prefix} {f}")


# ------------------------------------------------------------ the tests

def test_every_rank_holds_the_same_model(world):
    n, ranks = world
    for key, v in ranks[0].items():
        for r in range(1, n):
            np.testing.assert_array_equal(ranks[r][key], v,
                                          err_msg=f"rank {r}: {key}")


@pytest.mark.parametrize("masked", [False, True], ids=["plain", "masked"])
def test_dense_mesh_fit_matches_jax(world, masked):
    from singlet_tpu.parallel.sharded import make_mesh, sharded_nmf_fit

    n, ranks = world
    D = dense_operand()
    want = sharded_nmf_fit(D, K, mesh=make_mesh(n), tol=0.0, maxit=4,
                           w_init=w0_of(D.shape[0]), masked=masked)
    key = "dense_masked" if masked else "dense_plain"
    _close(ranks[0], key, want, DENSE_MASKED if masked else DENSE_PLAIN)
    np.testing.assert_allclose(ranks[0][f"{key}_tol_trace"],
                               want["tol_trace"], rtol=1e-3, atol=1e-6)
    if masked:
        np.testing.assert_allclose(ranks[0][f"{key}_test_mse"],
                                   want["test_mse"], rtol=1e-3)


@pytest.mark.parametrize("masked", [False, True], ids=["plain", "masked"])
def test_engine_fit_matches_jax(world, masked):
    n, ranks = world
    je = _jax_engine(n)
    want = je.fit(K, tol=0.0, maxit=4, w_init=w0_of(48), masked=masked)
    name = "masked" if masked else "plain"
    _close(ranks[0], name, want, FIT)
    if masked:
        np.testing.assert_allclose(ranks[0]["masked_test_mse"],
                                   want["test_mse"], rtol=5e-3)


def test_engine_ard_fit_matches_jax(world):
    n, ranks = world
    want = _jax_engine(n).ard_fit(
        K, w_init=w0_of(48), maxit=6, tol=1e-4, mask_seed=2)
    got = ranks[0]
    np.testing.assert_array_equal(got["ard_iter"], want.iter)
    np.testing.assert_allclose(got["ard_test_mse"], want.test_mse, rtol=5e-3)
    np.testing.assert_allclose(got["ard_tol"], want.tol, rtol=5e-3,
                               atol=1e-5)
    np.testing.assert_allclose(got["ard_score_overfit"], want.score_overfit,
                               rtol=5e-2, atol=1e-4)
    _close(got, "ard", want, FIT)


@pytest.mark.parametrize("solver", ["linked", "project", "batch", "gcnmf"])
def test_engine_solvers_match_jax(world, solver):
    n, ranks = world
    je = _jax_engine(n)
    w0 = w0_of(48)
    kw = dict(tol=0.0, maxit=4, w_init=w0)
    if solver == "linked":
        want = je.fit(K, link_h=link_h_of(600), **kw)
    elif solver == "project":
        h, d = je.project(w0)
        want = dict(h=h, d=d)
    elif solver == "batch":
        want = je.batch_fit(batch_of(600), K, **kw)
    else:
        want = je.gcnmf_fit(ring(600), K, **kw)
    _close(ranks[0], solver, want, FIT,
           ("h", "d") if solver == "project" else ("w", "d", "h"))


def test_run_nmf_on_mesh_matches_jax(world):
    from singlet_tpu import run_nmf as jax_run_nmf
    from singlet_tpu.parallel.sharded import make_mesh

    n, ranks = world
    want = jax_run_nmf(ell_operand(), rank=4, w_init=w0_of(48, 4), tol=0.0,
                       maxit=4, mesh=make_mesh(n))
    _close(ranks[0], "run_nmf", want, RUN_NMF)


def _jax_shared_init(monkeypatch):
    import jax.numpy as jnp
    from singlet_tpu.solvers import drivers as jdrivers

    monkeypatch.setattr(jdrivers, "init_w", lambda k, gp, gt, seed:
                        jnp.asarray(draw_init(k, gp, gt, seed)))


def _assert_frame(got: dict, prefix: str, want):
    import pandas as pd

    from test_torch_masked import _assert_frames_close

    df = pd.DataFrame({c: got[f"{prefix}_{c}"] for c in want.columns})
    df.attrs["class"] = "cross_validate_nmf_data"
    _assert_frames_close(df, want)


def test_cross_validate_on_mesh_matches_jax(world, monkeypatch):
    from singlet_tpu import cross_validate_nmf as jax_cv
    from singlet_tpu.parallel.sharded import make_mesh

    n, ranks = world
    _jax_shared_init(monkeypatch)
    want = jax_cv(ell_operand(), mesh=make_mesh(n), **CV)
    _assert_frame(ranks[0], "cv", want)


def test_ard_nmf_on_mesh_matches_jax(world, monkeypatch):
    from singlet_tpu import ard_nmf as jax_ard_nmf
    from singlet_tpu.parallel.sharded import make_mesh

    n, ranks = world
    _jax_shared_init(monkeypatch)
    want = jax_ard_nmf(ell_operand(), mesh=make_mesh(n), **ARD)
    _assert_frame(ranks[0], "ard_nmf", want.cv_data)
    assert int(ranks[0]["ard_nmf_k"]) == want.w.shape[1]
    np.testing.assert_allclose(ranks[0]["ard_nmf_w"], want.w, **FIT)


if __name__ == "__main__" and sys.argv[1:2] == ["--worker"]:
    worker_main({"fits": fits})

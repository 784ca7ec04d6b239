"""The port's package contract, on the CPU: it never imports jax, never runs
on the CPU unasked, imports its kernel modules without nvcc, dispatches CPU
tensors to the plain version only, routes large scipy input, chunk lists
and staged directories to the blocked-ELL engine, and refuses a ``mesh=``
that is not a "cells" DeviceMesh; ``checkpoint=`` of the fits and of the
``ard_nmf`` search saves; it exports every name of the JAX package's
``__all__``, and importing it imports neither matplotlib nor h5py."""

import os
import subprocess
import sys

import numpy as np
import pytest
import scipy.sparse as sp
import torch

import singlet_tpu_torch as stt
from singlet_tpu_torch import _build
from singlet_tpu_torch.ops import nnls, nnls_cuda
from singlet_tpu_torch.sparse.chunked import stage_chunks

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One torch intra-op thread in this module: the suite runs one worker
    process per core, and a thread pool per worker oversubscribes them
    (the plain versions here are many small ops)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _python(code, env=None):
    return subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=120)


def test_import_leaves_jax_out():
    """Every module of the port (the streaming ingest, the remaining
    solvers and the spatial graphs among them) and chip_smoke.py import
    neither jax nor singlet_tpu."""
    out = _python(
        "import importlib, pkgutil, sys, singlet_tpu_torch\n"
        "names = [m.name for m in pkgutil.walk_packages(\n"
        "    singlet_tpu_torch.__path__, 'singlet_tpu_torch.')]\n"
        "for name in names + ['chip_smoke']:\n"
        "    importlib.import_module(name)\n"
        "for name in ('native', 'sparse.chunked', 'solvers.linked',\n"
        "             'solvers.project', 'solvers.batch', 'solvers.gcnmf',\n"
        "             'solvers.mu', 'graphs.spatial'):\n"
        "    assert 'singlet_tpu_torch.' + name in names, name\n"
        "assert 'jax' not in sys.modules, 'jax imported'\n"
        "assert not [m for m in sys.modules if m == 'singlet_tpu'\n"
        "            or m.startswith('singlet_tpu.')], 'singlet_tpu'\n")
    assert out.returncode == 0, out.stderr


def test_kernel_module_imports_without_nvcc(tmp_path):
    env = dict(os.environ, PATH=str(tmp_path), CUDA_HOME=str(tmp_path))
    out = _python(
        "from singlet_tpu_torch import _build\n"
        "from singlet_tpu_torch.ops import bell_cuda, nnls_cuda\n"
        "assert nnls_cuda.LAUNCHES == nnls_cuda.LAUNCHES_BATCHED == 0\n"
        "assert bell_cuda.LAUNCHES_SPMM == bell_cuda.LAUNCHES_SPMM_T == 0\n"
        "try:\n"
        "    _build.find_nvcc()\n"
        "except RuntimeError as e:\n"
        "    print('raised', e)\n", env=env)
    assert out.returncode == 0, out.stderr
    assert "raised nvcc not found" in out.stdout


def test_missing_nvcc_raises(monkeypatch, tmp_path):
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.find_nvcc()


def test_cuda_without_a_card_raises(monkeypatch, rng):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    A = rng.random((20, 15)).astype(np.float32)
    with pytest.raises(RuntimeError, match="is_available"):
        stt.run_nmf(A, rank=3, device="cuda")
    with pytest.raises(RuntimeError, match="is_available"):
        stt.run_nmf(A, rank=3)              # the default device is cuda


@pytest.mark.parametrize("batched", [False, True])
def test_cpu_tensors_take_the_plain_version(rng, batched):
    n, k = 40, 5
    F = rng.random((64, k)).astype(np.float32)
    a = torch.as_tensor(F.T @ F)
    if batched:
        a = a.expand(n, k, k).contiguous()
    B = torch.as_tensor(rng.random((n, k)).astype(np.float32))
    X0 = torch.zeros(n, k)
    launches = (nnls_cuda.LAUNCHES, nnls_cuda.LAUNCHES_BATCHED)
    plain = nnls.PLAIN_CALLS
    X = nnls.solve_nnls(a, B, X0, L1=0.01)
    if batched:
        Xk = nnls_cuda.nnls_batch_cuda_batched_at(a.permute(2, 1, 0), B, X0,
                                                  L1=0.01)
    else:
        Xk = nnls_cuda.nnls_batch_cuda(a, B, X0, L1=0.01)
    assert (nnls_cuda.LAUNCHES, nnls_cuda.LAUNCHES_BATCHED) == launches
    assert nnls.PLAIN_CALLS == plain + 2
    torch.testing.assert_close(X, nnls.nnls_batch(a, B, X0, L1=0.01))
    torch.testing.assert_close(Xk, X, rtol=0, atol=0)


def test_run_nmf_config_and_checks(rng):
    A = rng.random((30, 20)).astype(np.float32)
    w_init = rng.random((30, 3)).astype(np.float32)
    m1 = stt.run_nmf(A, 3, tol=1e-3, maxit=8, L1=0.02, seed=2,
                     w_init=w_init, device="cpu")
    m2 = stt.run_nmf(A, 3, w_init=w_init, device="cpu",
                     config=stt.NMFConfig(tol=1e-3, maxit=8, L1=0.02, seed=2))
    np.testing.assert_array_equal(m1.w, m2.w)
    with pytest.raises(ValueError, match="L1"):
        stt.run_nmf(A, 3, L1=1.0, device="cpu")


_ENTRY_POINTS = {
    "run_nmf": lambda A, **kw: stt.run_nmf(A, 3, **kw),
    "cross_validate_nmf": lambda A, **kw: stt.cross_validate_nmf(
        A, ranks=[2, 3], verbose=0, **kw),
    "ard_nmf": lambda A, **kw: stt.ard_nmf(A, k_max=4, verbose=0, **kw),
}


@pytest.mark.parametrize("entry", sorted(_ENTRY_POINTS))
@pytest.mark.parametrize("what", ["mesh", "list", "dir", "checkpoint"])
def test_unported_routes_raise(rng, what, entry, tmp_path):
    """``mesh=`` of another kind than a 1-D ``"cells"`` DeviceMesh raises
    TypeError (the mesh itself is ported, A.4: tests/test_torch_mesh.py).
    Chunk lists and staged directories raised until streaming ingest was
    ported (A.2): they now fit on the blocked-ELL engine. ``checkpoint=``
    saves."""
    A = rng.random((30, 20)).astype(np.float32)
    fit = _ENTRY_POINTS[entry]
    if what == "mesh":
        with pytest.raises(TypeError, match="DeviceMesh.*'cells'"):
            fit(A, device="cpu", mesh=object())
    elif what in ("list", "dir"):
        src = [sp.csc_matrix(A[:, :10]), sp.csc_matrix(A[:, 10:])]
        if what == "dir":
            src = stage_chunks(str(tmp_path / "staged"), src)
        out = fit(src, device="cpu", maxit=5)
        if entry == "cross_validate_nmf":
            assert sorted(out["k"].unique()) == [2, 3]
            assert np.isfinite(out["test_error"]).all()
        else:
            assert out.w.shape[0] == 30 and out.h.shape[1] == 20
            assert np.isfinite(out.w).all()
    else:
        # ported: run_nmf has no checkpoint=; its engine nmf_fit (and the
        # masked fit ard_nmf_fit) do, and ard_nmf saves its search state
        ck = str(tmp_path / "ckpt")
        kw = dict(checkpoint=stt.CheckpointManager(ck, every=1), tol=0.0,
                  maxit=3, device="cpu")
        if entry == "run_nmf":
            stt.nmf_fit(A, 3, **kw)
        elif entry == "ard_nmf":
            fit(A, checkpoint=ck, device="cpu")
        else:
            stt.ard_nmf_fit(A, 3, **kw)
        assert os.listdir(ck)


@pytest.mark.parametrize("entry", sorted(_ENTRY_POINTS))
def test_big_scipy_reaches_the_ell_engine(rng, entry, monkeypatch):
    """scipy input above SPARSE_THRESHOLD dense entries is fitted on a
    ShardedEllEngine on the fit's device, and not densified."""
    from singlet_tpu_torch.solvers import drivers

    made = []
    real = drivers.ShardedEllEngine

    class Spy(real):
        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            made.append(self)

    monkeypatch.setattr(drivers, "SPARSE_THRESHOLD", 100)
    monkeypatch.setattr(drivers, "ShardedEllEngine", Spy)
    monkeypatch.setattr(drivers, "make_dense_providers", None)
    A = sp.csr_matrix(rng.random((30, 20)).astype(np.float32)
                      * (rng.random((30, 20)) < 0.5))
    out = _ENTRY_POINTS[entry](A, device="cpu", maxit=5)
    assert len(made) == 1 and made[0].device.type == "cpu"
    assert (made[0].rows_true, made[0].cols_true) == (30, 20)
    if entry == "cross_validate_nmf":
        assert sorted(out["k"].unique()) == [2, 3]
        assert np.isfinite(out["test_error"]).all()
    else:
        assert out.w.shape[0] == 30 and out.h.shape[1] == 20
        assert np.isfinite(out.w).all() and (np.diff(out.d) <= 0).all()


def test_exports_the_jax_surface():
    """Every name of ``singlet_tpu.__all__`` (read from the JAX package's
    ``__init__.py``, without importing jax) is in the port's ``__all__``
    and resolves, the plots through the lazy module ``__getattr__``."""
    import ast

    with open(os.path.join(ROOT, "singlet_tpu", "__init__.py")) as f:
        tree = ast.parse(f.read())
    names = next(ast.literal_eval(node.value) for node in tree.body
                 if isinstance(node, ast.Assign)
                 and any(getattr(t, "id", None) == "__all__"
                         for t in node.targets))
    assert [n for n in names if n not in stt.__all__] == []
    assert len(set(stt.__all__)) == len(stt.__all__)
    for name in stt.__all__:
        assert getattr(stt, name) is not None, name
    assert stt.__version__ == "0.1.0"
    with pytest.raises(AttributeError):
        stt.not_a_name


def test_import_leaves_matplotlib_and_h5py_out():
    """A machine with a card may lack matplotlib and h5py: importing the
    package imports neither (nor jax); a plot name imports matplotlib
    where it is installed."""
    import importlib.util

    code = ("import sys, singlet_tpu_torch as stt\n"
            "bad = [m for m in ('jax', 'matplotlib', 'h5py')\n"
            "       if m in sys.modules]\n"
            "assert not bad, bad\n")
    if importlib.util.find_spec("matplotlib") is not None:
        code += ("assert callable(stt.rank_plot)\n"
                 "assert 'matplotlib' in sys.modules\n")
    out = _python(code)
    assert out.returncode == 0, out.stderr

"""Parity of the port's blocked-ELL engine (``singlet_tpu_torch/parallel/
sharded_ell.py``) with the JAX package's engine on a one-device mesh, on
the CPU, on the same numpy inputs: the packer and planes, each step
(``_plain``, ``_masked``, ``_mse``, ``_project``), the engine's fits, and
the port's ELL fit against its dense fit (the drivers on the ELL route:
tests/test_torch_ell_drivers.py).

On the CPU the JAX engine runs its XLA route (tile formulation, f32 mask
products), the arithmetic the port's plain versions follow. Tolerances:
planes and packers bit for bit; one step rtol=1e-4, atol=1e-5 (the same
f32 products, summed in another order: the port takes all cells and genes
at once, the JAX engine blocks them); fits rtol=5e-3, atol=5e-4 on factors
and rtol=5e-3 on test MSE, those of tests/test_als.py and
tests/test_drivers.py, with equal ``iter`` lists.
"""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp
import torch

import singlet_tpu_torch as stt
from singlet_tpu import native as jnative
from singlet_tpu.ops.rngmask import seed_pair as jax_seed_pair
from singlet_tpu.parallel import sharded_ell as jell
from singlet_tpu.parallel.sharded import make_mesh
from singlet_tpu_torch import native as tnative
from singlet_tpu_torch.convert import ell_data_from_numpy
from singlet_tpu_torch.ops.rngmask import seed_pair
from singlet_tpu_torch.parallel import sharded_ell as tell
from test_drivers import _lowrank

FIT = dict(rtol=5e-3, atol=5e-4)
STEP = dict(rtol=1e-4, atol=1e-5)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One torch intra-op thread in this module: the suite runs one worker
    process per core, and a thread pool per worker oversubscribes them
    (the plain versions here are many small ops)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _sparse(genes=48, cells=300, density=0.2, seed=11):
    A = sp.random(genes, cells, density=density, random_state=seed,
                  dtype=np.float32, format="csc")
    A.data = np.abs(A.data) + 0.1
    return A


def _engines(A, cell_block=256, gene_block=32):
    je = jell.ShardedEllEngine(A, mesh=make_mesh(1), cell_block=cell_block,
                               gene_block=gene_block)
    te = tell.ShardedEllEngine(A, device="cpu", cell_block=cell_block,
                               gene_block=gene_block)
    return je, te


# ------------------------------------------------------------------ ingest

def _odd_matrices():
    A = _sparse(60, 90, seed=2)
    B = sp.csc_matrix(A)
    B.indices = B.indices.copy()
    for c in range(B.shape[1]):                # unsorted row indices
        lo, hi = B.indptr[c], B.indptr[c + 1]
        B.indices[lo:hi] = B.indices[lo:hi][::-1].copy()
        B.data[lo:hi] = B.data[lo:hi][::-1].copy()
    B.has_sorted_indices = False
    C = A.tolil()
    C[:, [0, 5]] = 0
    C[7, :] = 0
    return {"random": A, "unsorted": B, "empty_rows_cols": sp.csc_matrix(C),
            "all_empty": sp.csc_matrix((40, 20), dtype=np.float32)}


@pytest.mark.parametrize("name", sorted(_odd_matrices()))
def test_csc_to_bell_matches_jax(name):
    A = _odd_matrices()[name]
    n_gb, gb = 4, 16
    width = tell.bell_width(tell.bell_widths(A, n_gb, gb))
    assert width == jell.bell_width(jell.bell_widths(A, n_gb, gb))
    got = tnative.csc_to_bell(A, A.shape[1] + 5, gb, n_gb, width)
    want = jnative.csc_to_bell(A, A.shape[1] + 5, gb, n_gb, width)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)


def test_csc_to_bell_raises_on_undercount():
    A = _sparse(64, 30, density=0.5)
    width = tell.bell_width(tell.bell_widths(A, 2, 32))
    for pack in (tnative.csc_to_bell, jnative.csc_to_bell):
        with pytest.raises(ValueError, match="under-counts"):
            pack(A, 30, 32, 2, width - 8)


@pytest.mark.parametrize("shape,blocks", [((48, 300), (256, 32)),
                                          ((100, 70), (2048, 512)),
                                          ((600, 1100), (512, 256))])
def test_shard_ell_data_matches_jax(shape, blocks):
    A = _sparse(*shape, density=0.1)
    jd = jell.shard_ell_data(A, make_mesh(1), *blocks)
    td = tell.shard_ell_data(A, "cpu", *blocks)
    for f in ("b_li", "b_val", "nonempty", "gene_nonempty"):
        got = getattr(td, f).numpy()
        want = np.asarray(getattr(jd, f))
        assert got.dtype == want.dtype, f
        np.testing.assert_array_equal(got, want, err_msg=f)
    for f in ("b_width", "genes_true", "cells_true", "genes_pad",
              "cells_pad", "cell_block", "gene_block"):
        assert getattr(td, f) == getattr(jd, f), f
    assert tell.ell_geometry(*shape, *blocks) == jell.ell_geometry(
        *shape, make_mesh(1), *blocks)


def test_wide_ingest_warns():
    A = _sparse(512, 64, density=0.01).tolil()
    A[:300, 0] = 1.0
    with pytest.warns(UserWarning, match="inflating"):
        tell.shard_ell_data(sp.csc_matrix(A), "cpu")


# ------------------------------------------------------------------- steps

def _step_setup(rng, k=4):
    A = _sparse()
    jd = jell.shard_ell_data(A, make_mesh(1), 256, 32)
    td = ell_data_from_numpy(
        np.asarray(jd.b_li), np.asarray(jd.b_val), np.asarray(jd.nonempty),
        np.asarray(jd.gene_nonempty),
        {f: getattr(jd, f) for f in ("genes_true", "cells_true", "genes_pad",
                                     "cells_pad", "cell_block",
                                     "gene_block")}, device="cpu")
    W = np.zeros((jd.genes_pad, k), np.float32)
    W[:A.shape[0]] = rng.random((A.shape[0], k))
    H = np.zeros((jd.cells_pad, k), np.float32)
    H[:A.shape[1]] = rng.random((A.shape[1], k)) * 0.01
    return jd, td, W, H


@pytest.mark.parametrize("linked", [False, True])
def test_plain_step_matches_jax(rng, linked):
    jd, td, W, H = _step_setup(rng)
    k = W.shape[1]
    pens = (0.01, 0.02, 0.0, 0.001)
    links = ()
    if linked:
        links = ((rng.random((jd.cells_pad, k)) < 0.8).astype(np.float32),
                 (rng.random((jd.genes_pad, k)) < 0.8).astype(np.float32))
    plain_j = jell.build_sharded_ell_steps(jd, 20, linked=linked)[0]
    got = tell._build_local_fns(td, 20)["plain"](
        torch.as_tensor(W), torch.as_tensor(H), *pens,
        *[torch.as_tensor(x) for x in links], sweep_cap=8.0)
    want = plain_j(jd.b_li, jd.b_val, jd.nonempty, jd.gene_nonempty,
                   jnp.asarray(W), jnp.asarray(H),
                   *[jnp.asarray(x) for x in links],
                   *[jnp.float32(p) for p in pens], jnp.float32(8.0))
    for name, g, w in zip(("W", "H", "d", "tol"), got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **STEP,
                                   err_msg=name)


@pytest.mark.parametrize("k_true", [4, 3])
def test_masked_step_and_mse_match_jax(rng, k_true):
    jd, td, W, H = _step_setup(rng)
    W[:, k_true:] = 0.0
    H[:, k_true:] = 0.0
    pens = (0.01, 0.02, 0.0, 0.001)
    _, masked_j, mse_j = jell.build_sharded_ell_steps(jd, 8)
    fns = tell._build_local_fns(td, 8)
    got = fns["masked"](torch.as_tensor(W), torch.as_tensor(H),
                        seed_pair(17), *pens, k_true, sweep_cap=32.0)
    want = masked_j(jd.b_li, jd.b_val, jd.nonempty, jd.gene_nonempty,
                    jnp.asarray(W), jnp.asarray(H), jax_seed_pair(17),
                    *[jnp.float32(p) for p in pens], jnp.int32(k_true),
                    jnp.float32(32.0))
    for name, g, w in zip(("W", "H", "d", "tol"), got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **STEP,
                                   err_msg=name)
    err = fns["mse"](got[0], got[2], got[1], seed_pair(17))
    err_j = mse_j(jd.b_li, jd.b_val, want[0], want[2], want[1],
                  jax_seed_pair(17))
    np.testing.assert_allclose(float(err), float(err_j), rtol=1e-5)


def test_masked_block_budget_changes_nothing(rng, monkeypatch):
    """SINGLET_TPU_MASKED_BLOCK_GIB (read when the fit is built) merges
    storage blocks into larger masked blocks; the step is the same."""
    A = _sparse(48, 1000)
    te = tell.ShardedEllEngine(A, device="cpu", cell_block=256,
                               gene_block=32)
    w0 = rng.random((48, 3)).astype(np.float32)
    kw = dict(w_init=w0, tol=0.0, maxit=2, masked=True, inv_density=8)
    one = te.fit(3, **kw)
    monkeypatch.setenv("SINGLET_TPU_MASKED_BLOCK_GIB", "1")
    merged = te.fit(3, **kw)
    np.testing.assert_allclose(merged["w"], one["w"], **STEP)
    np.testing.assert_allclose(merged["test_mse"], one["test_mse"],
                               rtol=1e-5)


# ------------------------------------------------------------------ engine

@pytest.mark.parametrize("case", ["plain", "masked", "linked", "pairs"])
def test_engine_fit_matches_jax(rng, case):
    A = _sparse()
    je, te = _engines(A)
    k = 4
    w0 = rng.random((A.shape[0], k)).astype(np.float32)
    kw = dict(w_init=w0, tol=1e-5, maxit=6)
    if case == "masked":
        kw.update(masked=True, inv_density=8, mask_seed=3)
    elif case == "linked":
        kw.update(link_h=(rng.random((A.shape[1], k)) < 0.7).astype(
            np.float32), link_w=(rng.random((A.shape[0], k)) < 0.7).astype(
                np.float32))
    elif case == "pairs":
        kw.update(L1=(0.05, 0.0), L2=(0.0, 0.01))
    got, want = te.fit(k, **kw), je.fit(k, **kw)
    assert len(got["tol_trace"]) == len(want["tol_trace"])
    np.testing.assert_allclose(got["tol_trace"], want["tol_trace"], **FIT)
    for f in ("w", "h", "d"):
        np.testing.assert_allclose(got[f], want[f], **FIT, err_msg=f)
    if case == "masked":
        np.testing.assert_allclose(got["test_mse"], want["test_mse"],
                                   rtol=5e-3)


# (maxit, trace_test_mse, tol, overfit_threshold): tests/test_torch_
# masked.py's schedules: a plain run, an early stop, a tail trace
ARD_CASES = {"oracle": (6, 2, 1e-3, 1e-3), "early_stop": (30, 1, 1e-6, 1e-6),
             "tail_trace": (5, 3, 1e-6, 1.0)}


@pytest.mark.parametrize("case", sorted(ARD_CASES))
def test_engine_ard_fit_matches_jax(rng, case):
    maxit, trace, tol, threshold = ARD_CASES[case]
    A = sp.csc_matrix(_lowrank(rng, genes=40, cells=300, k=3))
    je, te = _engines(A)
    w0 = rng.random((40, 3)).astype(np.float32)
    kw = dict(w_init=w0, mask_seed=5, inv_density=5, tol=tol, maxit=maxit,
              L1=0.01, overfit_threshold=threshold, trace_test_mse=trace)
    got = te.ard_fit(3, **kw)
    want = je.ard_fit(3, k_bucket=1, **kw)
    assert got.iter == want.iter
    np.testing.assert_allclose(got.test_mse, want.test_mse, rtol=5e-3)
    np.testing.assert_allclose(got.tol, want.tol, rtol=5e-3, atol=1e-5)
    np.testing.assert_allclose(got.score_overfit, want.score_overfit,
                               rtol=5e-2, atol=1e-4)
    for f in ("w", "h", "d"):
        np.testing.assert_allclose(getattr(got, f), getattr(want, f), **FIT,
                                   err_msg=f)
    if case == "tail_trace":
        assert got.iter == [0, 3, 5]


@pytest.mark.parametrize("transposed", [False, True])
def test_engine_project_matches_jax(rng, transposed):
    A = _sparse()
    je, te = _engines(A)
    w = rng.random((A.shape[0], 5)).astype(np.float32)
    w_in = w.T.copy() if transposed else w
    h, d = te.project(w_in, L1=0.02)
    hj, dj = je.project(w_in, L1=0.02)
    assert h.shape == (5, A.shape[1])
    np.testing.assert_allclose(h, hj, **FIT)
    np.testing.assert_allclose(d, dj, **FIT)
    with pytest.raises(ValueError, match="common edge"):
        te.project(w[:10])


@pytest.mark.parametrize("masked", [False, True])
def test_ell_fit_matches_dense_fit(rng, masked):
    """The port's ELL engine against the port's dense engine (both plain
    versions on the CPU): one operand, two storage layers."""
    A = _sparse(40, 300)
    w0 = rng.random((40, 3)).astype(np.float32)
    te = tell.ShardedEllEngine(A, device="cpu", cell_block=256,
                               gene_block=32)
    dense = A.toarray()
    if masked:
        kw = dict(w_init=w0, mask_seed=4, inv_density=6, tol=0.0, maxit=4,
                  trace_test_mse=1, overfit_threshold=1.0)
        got = te.ard_fit(3, **kw)
        want = stt.ard_nmf_fit(dense, 3, device="cpu", **kw)
        assert got.iter == want.iter
        np.testing.assert_allclose(got.test_mse, want.test_mse, rtol=5e-3)
        got, want = vars(got), vars(want)
    else:
        got = te.fit(3, w_init=w0, tol=0.0, maxit=5)
        res = stt.nmf_fit(dense, 3, w_init=w0, tol=0.0, maxit=5,
                          device="cpu")
        want = dict(w=res.w, h=res.h, d=res.d)
    for f in ("w", "h", "d"):
        np.testing.assert_allclose(got[f], want[f], **FIT, err_msg=f)


def test_engine_refusals(rng, tmp_path):
    """The engine refuses malformed links, ``chunk_iters``, a graph that
    is not cells x cells (``gcnmf_fit``) and batch ids of another length
    (``batch_fit``); ``checkpoint=`` of ``fit`` and ``ard_fit`` saves."""
    A = _sparse()
    te = tell.ShardedEllEngine(A, device="cpu", cell_block=256,
                               gene_block=32)
    with pytest.raises(ValueError, match="masked"):
        te.fit(3, masked=True, link_h=np.ones((A.shape[1], 3)))
    with pytest.raises(ValueError, match="link_w"):
        te.fit(3, link_w=np.ones((5, 3)))
    with pytest.raises(NotImplementedError, match="left out.*A.6"):
        te.fit(3, chunk_iters=2)
    for method in ("fit", "ard_fit"):
        ck = tmp_path / method
        getattr(te, method)(3, tol=0.0, maxit=2,
                            checkpoint=stt.CheckpointManager(str(ck),
                                                             every=1))
        assert os.listdir(ck)
    with pytest.raises(ValueError, match="cells x cells"):
        te.gcnmf_fit(sp.identity(5, format="csc"), 3, maxit=1)
    with pytest.raises(ValueError, match="batch_id"):
        te.batch_fit(np.zeros(5, np.int64), 3, maxit=1)
    out = tell.sharded_ell_nmf_fit(A, 3, device="cpu", tol=0.0, maxit=2)
    assert out["w"].shape == (A.shape[0], 3) and len(out["tol_trace"]) == 2
    assert (te.rows_pad, te.rows_true, te.cols_true) == (64, 48, 300)

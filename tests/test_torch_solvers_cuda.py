"""The remaining solvers on the card against the same calls on the CPU: the
blocked-ELL engine's ``batch_fit`` and ``gcnmf_fit`` (kernels B1, B3, B4
only, no plain call), the dense ``nmf_batch``, ``gcnmf``, ``project_model``
and ``run_linked_nmf``, ``mu_nmf``, the graphs ``local_knn`` and
``snn_graph``, and kernel B1 with an (n, k) L1 and ``update_mask`` (the
batch loop's h-side solve) against its plain version.

A CUDA kernel has no CPU mode, so every test here needs a card and skips
without one. On a machine with a card (and without jax, which
``tests/conftest.py`` imports), run:

    python -m pytest --noconftest tests/test_torch_solvers_cuda.py -q

Tolerances: fits rtol=5e-3, atol=5e-4 with equal iteration counts (the
fit gate of ``chip_smoke.py``, tests/test_als.py's); B1 rtol=5e-3,
atol=1e-6 (tests/test_pallas_nnls.py's); graphs the same edges, values
within rtol 1e-4.
"""

import numpy as np
import pytest
import scipy.sparse as sp
import torch

import singlet_tpu_torch as stt
from singlet_tpu_torch.ops import bell, bell_cuda, nnls, nnls_cuda
from singlet_tpu_torch.parallel import sharded_ell as tell

pytestmark = pytest.mark.cuda

FIT = dict(rtol=5e-3, atol=5e-4)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: kernels B1, B3 and B4 have no CPU "
                    "mode")
    return torch.device("cuda")


def _operand(genes=300, cells=1500, seed=4):
    A = sp.random(genes, cells, density=0.1, random_state=seed,
                  dtype=np.float32, format="csc")
    A.data = np.abs(A.data) + 0.1
    return A


def _counts():
    return {"B1": nnls_cuda.LAUNCHES, "B2": nnls_cuda.LAUNCHES_BATCHED,
            "B3": bell_cuda.LAUNCHES_SPMM, "B4": bell_cuda.LAUNCHES_SPMM_T,
            "plain": nnls.PLAIN_CALLS + bell.PLAIN_CALLS}


def _launched(before):
    return {key: n - before[key] for key, n in _counts().items()}


def _ring(n):
    return sp.diags([np.ones(n - 1), np.ones(n), np.ones(n - 1)],
                    [-1, 0, 1], format="csc").astype(np.float32) / 3.0


def _close_fits(got, want):
    assert len(got["tol_trace"]) == len(want["tol_trace"])
    for f in ("w", "d", "h", "tol_trace"):
        np.testing.assert_allclose(got[f], want[f], **FIT, err_msg=f)


@pytest.mark.parametrize("fit", ["batch_fit", "gcnmf_fit"])
def test_engine_fits_on_the_card_match_cpu(cuda, fit):
    A = _operand()
    w0 = np.random.default_rng(1).random((A.shape[0], 8)).astype(np.float32)
    kw = dict(tol=0.0, maxit=4, w_init=w0)
    args = ((np.arange(A.shape[1]) % 4,) if fit == "batch_fit"
            else (_ring(A.shape[1]),))
    engines = {dev: tell.ShardedEllEngine(A, device=dev, cell_block=512,
                                          gene_block=128)
               for dev in ("cpu", "cuda")}
    want = getattr(engines["cpu"], fit)(*args, 8, **kw)
    before = _counts()
    got = getattr(engines["cuda"], fit)(*args, 8, **kw)
    torch.cuda.synchronize()
    # per iteration one B3 (B = A^T W) and one B4, two B1; GCNMF two more
    # B3 over the graph's planes
    b3 = 3 if fit == "gcnmf_fit" else 1
    assert _launched(before) == dict(B1=8, B2=0, B3=4 * b3, B4=4, plain=0)
    _close_fits(got, want)


def test_b1_with_per_cell_l1_and_update_mask(cuda):
    rng = np.random.default_rng(3)
    n, k = 2048, 50
    F = rng.random((128, k)).astype(np.float32)
    a = torch.as_tensor(F.T @ F + 1e-15 * np.eye(k, dtype=np.float32),
                        device=cuda)
    B = torch.as_tensor((rng.random((n, 128)) @ F).astype(np.float32),
                        device=cuda)
    X0 = torch.as_tensor((rng.random((n, k)) * (rng.random((n, k)) < 0.5))
                         .astype(np.float32), device=cuda)
    L1 = torch.as_tensor(0.01 + 0.05 * rng.random((n, k)), device=cuda,
                         dtype=torch.float32)
    mask = torch.as_tensor(rng.random(n) < 0.9, device=cuda)
    for cap in (8.0, None):
        kw = dict(L1=L1, L2=0.0, update_mask=mask, sweep_cap=cap)
        before = nnls_cuda.LAUNCHES
        Xk = nnls.solve_nnls(a, B, X0, **kw)
        Xp = nnls.nnls_batch(a, B, X0, **kw)
        torch.cuda.synchronize()
        assert nnls_cuda.LAUNCHES == before + 1
        np.testing.assert_allclose(Xk.cpu().numpy(), Xp.cpu().numpy(),
                                   rtol=5e-3, atol=1e-6)
        assert torch.equal(Xk[~mask], X0[~mask])


def test_dense_solvers_on_the_card_match_cpu(cuda):
    A = _operand(genes=200, cells=700).toarray()
    rng = np.random.default_rng(2)
    w0 = rng.random((200, 6)).astype(np.float32)
    bid = np.arange(700) % 3
    link_h = np.ones((6, 700), np.float32)
    link_h[0, :350] = 0.0
    for call in (
            lambda dev: stt.nmf_batch(A, 6, bid, tol=0.0, maxit=4,
                                      w_init=w0, device=dev),
            lambda dev: stt.gcnmf(A, _ring(700), 6, tol=0.0, maxit=4,
                                  w_init=w0, device=dev),
            lambda dev: stt.run_linked_nmf(A, w0, link_h=link_h, tol=0.0,
                                           maxit=4, verbose=False,
                                           device=dev)):
        got, want = call("cuda"), call("cpu")
        for f in ("w", "d", "h"):
            np.testing.assert_allclose(getattr(got, f), getattr(want, f),
                                       **FIT, err_msg=f)
    h, d = stt.project_model(A, w0, device="cuda")
    h_c, d_c = stt.project_model(A, w0, device="cpu")
    np.testing.assert_allclose(h, h_c, **FIT)
    np.testing.assert_allclose(d, d_c, rtol=FIT["rtol"])


@pytest.mark.parametrize("faithful", [False, True])
def test_mu_nmf_on_the_card_matches_cpu(cuda, monkeypatch, faithful):
    """From one init: the card's and the CPU's generators differ."""
    from singlet_tpu_torch.solvers import mu

    A = _operand(genes=200, cells=700).toarray()
    rng = np.random.default_rng(6)
    u = rng.random((200, 6)).astype(np.float32) + 1e-3
    z = np.abs(rng.standard_normal((6, 700))).astype(np.float32) + 1e-3
    monkeypatch.setattr(mu, "_mu_init", lambda g, c, k, seed, device: (
        torch.as_tensor(u, device=device), torch.as_tensor(z, device=device)))
    got, want = (stt.mu_nmf(A, 6, tol=0.0, maxit=3, faithful=faithful,
                            device=dev) for dev in ("cuda", "cpu"))
    _close_fits(got, want)


def test_graphs_on_the_card_match_cpu(cuda):
    """Integer profiles on a grid of integer coordinates: every distance
    is exact in float32 on both devices, so the edges must be the same."""
    rng = np.random.default_rng(5)
    side = 60
    n = side * side
    M = rng.integers(0, 4, (8, n)).astype(np.float32)
    cx = (np.arange(n) % side).astype(np.float32)
    cy = (np.arange(n) // side).astype(np.float32)
    for metric in ("euclidean", "jaccard", "cosine", "manhattan",
                   "hamming"):
        kw = dict(k=10, radius=3.0, metric=metric, block=256)
        got = stt.local_knn(M, cx, cy, device="cuda", **kw)
        want = stt.local_knn(M, cx, cy, device="cpu", **kw)
        np.testing.assert_array_equal(got.indptr, want.indptr)
        np.testing.assert_array_equal(got.indices, want.indices)
        np.testing.assert_allclose(got.data, want.data, rtol=1e-4)
        S = stt.snn_graph(got, 0.05, device="cuda")
        S_c = stt.snn_graph(got, 0.05, device="cpu")
        np.testing.assert_array_equal(S.indptr, S_c.indptr)
        np.testing.assert_array_equal(S.indices, S_c.indices)
        np.testing.assert_array_equal(S.data, S_c.data)

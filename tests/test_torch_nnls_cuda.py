"""Kernels B1 and B2 (``singlet_tpu_torch/ops/nnls_cuda.py``) on the card
against their plain PyTorch version on the same inputs.

A CUDA kernel has no CPU mode, so every test here needs a card and skips
without one. On a machine with a card (and without jax, which
``tests/conftest.py`` imports), run:

    python -m pytest --noconftest tests/test_torch_nnls_cuda.py -q

Tolerance rtol=5e-3, atol=1e-6, that of tests/test_pallas_nnls.py: kernel and
plain version round every coordinate step alike, but sum the sweep-end tol in
another order, so a borderline column may run one sweep more or fewer.
B1 also takes an (n, k) L1 (the plain version's per-coordinate branch); a
run gives the same bits every time.
"""

import numpy as np
import pytest
import torch

from singlet_tpu_torch.ops import nnls, nnls_cuda

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: kernels B1 and B2 have no CPU "
                    "mode")
    return torch.device("cuda")


def _problem(n, k, seed, device):
    rng = np.random.default_rng(seed)
    m = max(64, 2 * k)
    F = rng.random((m, k)).astype(np.float32)
    a = (F.T @ F + 1e-15 * np.eye(k)).astype(np.float32)
    B = (rng.random((n, m)) @ F).astype(np.float32)
    X0 = (rng.random((n, k)) * (rng.random((n, k)) < 0.5)).astype(np.float32)
    mask = rng.random(n) < 0.9
    return [torch.as_tensor(x, device=device) for x in (a, B, X0, mask)]


@pytest.mark.parametrize("n,k", [(256, 9), (1500, 10), (2048, 50),
                                 (1024, 100), (300, 200), (300, 256),
                                 (200, 300)])
@pytest.mark.parametrize("sweep_cap", [None, 8.0])
def test_kernel_matches_plain(cuda, n, k, sweep_cap):
    a, B, X0, mask = _problem(n, k, n + k, cuda)
    kw = dict(L1=0.01, L2=0.001, update_mask=mask, sweep_cap=sweep_cap)
    before = nnls_cuda.LAUNCHES
    Xk = nnls_cuda.nnls_batch_cuda(a, B, X0, **kw)
    Xp = nnls.nnls_batch(a, B, X0, **kw)
    torch.cuda.synchronize()
    assert nnls_cuda.LAUNCHES == before + 1
    np.testing.assert_allclose(Xk.cpu().numpy(), Xp.cpu().numpy(),
                               rtol=5e-3, atol=1e-6)
    assert torch.equal(Xk[~mask], X0[~mask])


def test_kernel_n_coord_and_no_mask(cuda):
    a, B, X0, _ = _problem(512, 12, 7, cuda)
    kw = dict(L1=0.02, n_coord=5.0, max_sweeps=40)
    Xk = nnls_cuda.nnls_batch_cuda(a, B, X0, **kw)
    Xp = nnls.nnls_batch(a, B, X0, **kw)
    np.testing.assert_allclose(Xk.cpu().numpy(), Xp.cpu().numpy(),
                               rtol=5e-3, atol=1e-6)


def test_solve_nnls_launches_kernel_only(cuda):
    a, B, X0, mask = _problem(333, 6, 3, cuda)
    launches, plain = nnls_cuda.LAUNCHES, nnls.PLAIN_CALLS
    nnls.solve_nnls(a, B, X0, L1=0.01, update_mask=mask, sweep_cap=8.0)
    assert nnls_cuda.LAUNCHES == launches + 1
    assert nnls.PLAIN_CALLS == plain


def test_solve_nnls_raises_off_the_kernel(cuda):
    """Per-column Grams with (n, k) L1 (B2 takes a scalar L1) and float64
    raise rather than run the plain loop on the card; a shared Gram with
    (n, k) L1 goes to B1."""
    a, B, X0, _ = _problem(64, 5, 4, cuda)
    with pytest.raises(NotImplementedError, match="batch"):
        nnls.solve_nnls(a.expand(64, 5, 5).contiguous(), B, X0,
                        L1=torch.full_like(B, 0.01))
    with pytest.raises(NotImplementedError):
        nnls.solve_nnls(a.double(), B.double(), X0.double())
    counts = (nnls_cuda.LAUNCHES, nnls.PLAIN_CALLS)
    nnls.solve_nnls(a, B, X0, L1=torch.full_like(B, 0.01))
    assert (nnls_cuda.LAUNCHES, nnls.PLAIN_CALLS) == (counts[0] + 1,
                                                      counts[1])


@pytest.mark.parametrize("n,k", [(333, 7), (1500, 10), (2048, 50),
                                 (1024, 100), (300, 224), (300, 256),
                                 (200, 300)])
@pytest.mark.parametrize("sweep_cap", [None, 8.0])
def test_kernel_l1_array_matches_plain(cuda, n, k, sweep_cap):
    """B1 with a per-coordinate (n, k) L1 against the plain version's
    (n, k) branch, through solve_nnls (one launch, no plain call); masked
    columns return X0 bit for bit."""
    a, B, X0, mask = _problem(n, k, n + k + 1, cuda)
    L1 = torch.rand((n, k), generator=torch.Generator(device=cuda)
                    .manual_seed(k), device=cuda) * 0.05
    kw = dict(L2=0.001, update_mask=mask, sweep_cap=sweep_cap)
    counts = (nnls_cuda.LAUNCHES, nnls.PLAIN_CALLS)
    Xk = nnls.solve_nnls(a, B, X0, L1=L1, **kw)
    assert (nnls_cuda.LAUNCHES, nnls.PLAIN_CALLS) == (counts[0] + 1,
                                                      counts[1])
    Xp = nnls.nnls_batch(a, B, X0, L1=L1, **kw)
    torch.cuda.synchronize()
    np.testing.assert_allclose(Xk.cpu().numpy(), Xp.cpu().numpy(),
                               rtol=5e-3, atol=1e-6)
    assert torch.equal(Xk[~mask], X0[~mask])


def test_kernel_takes_every_k_in_one_launch(cuda):
    """Every k in 1..512 is one launch, at an n that is no multiple of a
    warp's columns, with the same bits twice and X0 on masked columns;
    against the plain version at the plan's edges."""
    edges = {1, 2, 16, 17, 31, 32, 33, 48, 63, 64, 65, 100, 127, 128, 129,
             200, 208, 209, 223, 224, 225, 256, 257, 300, 320, 321, 447,
             448, 449, 511, 512}
    for k in range(1, nnls_cuda.MAX_K + 1):
        a, B, X0, mask = _problem(37, k, k, cuda)
        kw = dict(L1=0.01, L2=0.001, update_mask=mask, sweep_cap=3.0)
        before = nnls_cuda.LAUNCHES
        Xk = nnls_cuda.nnls_batch_cuda(a, B, X0, **kw)
        assert nnls_cuda.LAUNCHES == before + 1, k
        assert torch.equal(Xk, nnls_cuda.nnls_batch_cuda(a, B, X0, **kw)), k
        assert torch.equal(Xk[~mask], X0[~mask]), k
        if k in edges:
            Xp = nnls.nnls_batch(a, B, X0, **kw)
            np.testing.assert_allclose(Xk.cpu().numpy(), Xp.cpu().numpy(),
                                       rtol=5e-3, atol=1e-6, err_msg=str(k))


@pytest.mark.parametrize("n", [1, 7, 9, 1025, 8193])
def test_kernel_any_column_count(cuda, n):
    """Column counts that leave a warp's column set or the grid part
    full (the plan's G varies with n) give the plain version's result."""
    a, B, X0, mask = _problem(n, 50, n, cuda)
    kw = dict(L1=0.01, L2=0.001, update_mask=mask, sweep_cap=8.0)
    Xk = nnls_cuda.nnls_batch_cuda(a, B, X0, **kw)
    Xp = nnls.nnls_batch(a, B, X0, **kw)
    np.testing.assert_allclose(Xk.cpu().numpy(), Xp.cpu().numpy(),
                               rtol=5e-3, atol=1e-6)
    assert torch.equal(Xk[~mask], X0[~mask])


def test_wrapper_checks_inputs(cuda):
    a, B, X0, mask = _problem(64, 5, 5, cuda)
    with pytest.raises(ValueError, match="contiguous"):
        nnls_cuda.nnls_batch_cuda(a, B.T.contiguous().T, X0)
    with pytest.raises(ValueError, match="shape"):
        nnls_cuda.nnls_batch_cuda(a, B, X0[:10])
    with pytest.raises(TypeError):
        nnls_cuda.nnls_batch_cuda(a, B, X0, update_mask=mask.float())
    with pytest.raises(ValueError, match="shape"):
        nnls_cuda.nnls_batch_cuda(a, B, X0, L1=torch.zeros_like(B)[:, :3])


def test_run_nmf_on_card_matches_cpu(cuda):
    import singlet_tpu_torch as stt

    rng = np.random.default_rng(11)
    A = (rng.random((300, 200)) < 0.2) * rng.random((300, 200))
    w_init = rng.random((300, 6)).astype(np.float32)
    kw = dict(rank=6, tol=0.0, maxit=6, w_init=w_init)
    launches = nnls_cuda.LAUNCHES
    m_gpu = stt.run_nmf(A, device="cuda", **kw)
    assert nnls_cuda.LAUNCHES == launches + 12
    m_cpu = stt.run_nmf(A, device="cpu", **kw)
    for f in ("w", "h", "d"):
        np.testing.assert_allclose(getattr(m_gpu, f), getattr(m_cpu, f),
                                   rtol=5e-3, atol=5e-4)


# ------------------------------------------------------------- kernel B2

def _masked_problem_packed(n, k, seed, device):
    """A masked half-update's solve: a_full (k, k), the packed Gram
    corrections of each column's 5% masked rows packed_t (npairs, n), iu,
    B, a warm X0 with zeros and a 90% update mask."""
    from singlet_tpu_torch.ops import linalg

    g = torch.Generator(device=device).manual_seed(seed)
    rows = max(128, 2 * k)
    F = torch.rand((rows, k), generator=g, device=device)
    iu = linalg.triu_pairs(k)
    m = torch.rand((n, rows), generator=g, device=device) < 0.05
    packed_t = linalg.mask_dot_t(linalg.packed_outer_products(F, iu), m, 1)
    a_full = F.T @ F + 1e-15 * torch.eye(k, device=device)
    G = torch.rand((n, rows), generator=g, device=device)
    B = torch.where(m, 0.0, G) @ F
    X0 = (torch.rand((n, k), generator=g, device=device)
          * (torch.rand((n, k), generator=g, device=device) < 0.5))
    mask = torch.rand(n, generator=g, device=device) < 0.9
    return a_full, packed_t, iu, B, X0, mask


def _masked_problem(n, k, seed, device):
    """Per-column Grams as a masked half-update makes them, in B2's
    (k, k, n) layout: a_full minus the packed Gram of 5% masked rows."""
    from singlet_tpu_torch.ops import linalg

    a_full, packed_t, iu, B, X0, mask = _masked_problem_packed(n, k, seed,
                                                               device)
    at = linalg.unpack_sym_from_t(packed_t, k, iu, a_full)
    return at, B, X0, mask


@pytest.mark.parametrize("n,k", [(256, 9), (1500, 10), (2048, 50),
                                 (1024, 100), (130, 224), (130, 256),
                                 (96, 300)])
@pytest.mark.parametrize("sweep_cap", [None, 32.0])
def test_batched_kernel_matches_plain(cuda, n, k, sweep_cap):
    at, B, X0, mask = _masked_problem(n, k, n + k, cuda)
    kw = dict(L1=0.01, L2=0.001, update_mask=mask, sweep_cap=sweep_cap)
    before = nnls_cuda.LAUNCHES_BATCHED
    Xk = nnls_cuda.nnls_batch_cuda_batched_at(at, B, X0, **kw)
    Xp = nnls.nnls_batch(at.permute(2, 1, 0), B, X0, **kw)
    torch.cuda.synchronize()
    assert nnls_cuda.LAUNCHES_BATCHED == before + 1
    np.testing.assert_allclose(Xk.cpu().numpy(), Xp.cpu().numpy(),
                               rtol=5e-3, atol=1e-6)
    assert torch.equal(Xk[~mask], X0[~mask])


def test_batched_kernel_n_coord_and_no_mask(cuda):
    at, B, X0, _ = _masked_problem(512, 12, 7, cuda)
    kw = dict(L1=0.02, n_coord=5.0, max_sweeps=40)
    Xk = nnls_cuda.nnls_batch_cuda_batched_at(at, B, X0, **kw)
    Xp = nnls.nnls_batch(at.permute(2, 1, 0), B, X0, **kw)
    np.testing.assert_allclose(Xk.cpu().numpy(), Xp.cpu().numpy(),
                               rtol=5e-3, atol=1e-6)


def test_kernel_refuses_large_k(cuda):
    k = nnls_cuda.MAX_K + 1
    a = torch.eye(k, device=cuda)
    B = torch.ones((4, k), device=cuda)
    with pytest.raises(NotImplementedError, match="B1 takes k <= 512"):
        nnls_cuda.nnls_batch_cuda(a, B, torch.zeros_like(B))


def test_batched_kernel_refuses_large_k(cuda):
    k = nnls_cuda.MAX_K_BATCHED + 1
    at = torch.ones((k, k, 4), device=cuda)
    B = torch.ones((4, k), device=cuda)
    with pytest.raises(NotImplementedError, match="B2"):
        nnls_cuda.nnls_batch_cuda_batched_at(at, B, torch.zeros_like(B))


def test_solve_nnls_sends_per_column_grams_to_b2(cuda):
    at, B, X0, mask = _masked_problem(333, 6, 3, cuda)
    a = at.permute(2, 1, 0).contiguous()       # (n, k, k)
    counts = (nnls_cuda.LAUNCHES, nnls_cuda.LAUNCHES_BATCHED,
              nnls.PLAIN_CALLS)
    X = nnls.solve_nnls(a, B, X0, L1=0.01, update_mask=mask, sweep_cap=32.0)
    assert (nnls_cuda.LAUNCHES, nnls_cuda.LAUNCHES_BATCHED,
            nnls.PLAIN_CALLS) == (counts[0], counts[1] + 1, counts[2])
    Xp = nnls.nnls_batch(a, B, X0, L1=0.01, update_mask=mask, sweep_cap=32.0)
    np.testing.assert_allclose(X.cpu().numpy(), Xp.cpu().numpy(),
                               rtol=5e-3, atol=1e-6)


def test_masked_fit_on_card_matches_cpu(cuda):
    import singlet_tpu_torch as stt

    rng = np.random.default_rng(12)
    A = (rng.random((300, 200)) < 0.2) * rng.random((300, 200))
    w_init = rng.random((300, 6)).astype(np.float32)
    # overfit_threshold 1 keeps the early stop off: 4 iterations
    kw = dict(w_init=w_init, tol=0.0, maxit=4, trace_test_mse=1,
              inv_density=10, overfit_threshold=1.0)
    counts = (nnls_cuda.LAUNCHES, nnls_cuda.LAUNCHES_BATCHED,
              nnls.PLAIN_CALLS)
    r_gpu = stt.ard_nmf_fit(A, 6, device="cuda", **kw)
    # one block per side at this size: two B2 launches per iteration
    assert (nnls_cuda.LAUNCHES, nnls_cuda.LAUNCHES_BATCHED,
            nnls.PLAIN_CALLS) == (counts[0], counts[1] + 8, counts[2])
    r_cpu = stt.ard_nmf_fit(A, 6, device="cpu", **kw)
    assert r_gpu.iter == r_cpu.iter
    np.testing.assert_allclose(r_gpu.test_mse, r_cpu.test_mse, rtol=5e-3)
    for f in ("w", "h", "d"):
        np.testing.assert_allclose(getattr(r_gpu, f), getattr(r_cpu, f),
                                   rtol=5e-3, atol=5e-4)


# ------------------------------------------------------ B2's packed entry

@pytest.mark.parametrize("n,k", [(256, 9), (1500, 10), (2048, 50),
                                 (1024, 100), (2048, 100), (130, 224),
                                 (130, 256), (96, 300), (512, 300)])
@pytest.mark.parametrize("sweep_cap", [None, 32.0])
def test_packed_entry_matches_tile_entry_and_plain(cuda, n, k, sweep_cap):
    """The packed entry gives the tile entry's bits on the unpacked Grams,
    and is within the tolerance of the plain version; masked columns
    return X0."""
    from singlet_tpu_torch.ops import linalg

    a_full, packed_t, iu, B, X0, mask = _masked_problem_packed(
        n, k, n + k, cuda)
    at = linalg.unpack_sym_from_t(packed_t, k, iu, a_full)
    kw = dict(L1=0.01, L2=0.001, update_mask=mask, sweep_cap=sweep_cap)
    before = nnls_cuda.LAUNCHES_BATCHED
    Xk = nnls_cuda.nnls_batch_cuda_batched_packed_t(a_full, packed_t, iu, B,
                                                    X0, **kw)
    assert nnls_cuda.LAUNCHES_BATCHED == before + 1
    Xt = nnls_cuda.nnls_batch_cuda_batched_at(at, B, X0, **kw)
    Xp = nnls.nnls_batch(at.permute(2, 1, 0), B, X0, **kw)
    torch.cuda.synchronize()
    assert torch.equal(Xk, Xt)
    np.testing.assert_allclose(Xk.cpu().numpy(), Xp.cpu().numpy(),
                               rtol=5e-3, atol=1e-6)
    assert torch.equal(Xk[~mask], X0[~mask])


def test_both_entries_take_every_k(cuda):
    """Every k in 1..512 launches on both entries (each k picks its
    shared-memory or streamed layout) with the same bits; against the
    plain version at the layouts' edges."""
    from singlet_tpu_torch.ops import linalg

    edges = {1, 16, 17, 32, 33, 48, 49, 64, 65, 80, 81, 96, 97, 106, 107,
             112, 113, 128, 129, 192, 193, 240, 241, 256, 257, 320, 321, 384,
             385, 512}
    for k in range(1, nnls_cuda.MAX_K_BATCHED + 1):
        a_full, packed_t, iu, B, X0, mask = _masked_problem_packed(
            11, k, k, cuda)
        at = linalg.unpack_sym_from_t(packed_t, k, iu, a_full)
        kw = dict(L1=0.01, L2=0.001, update_mask=mask, sweep_cap=2.0)
        Xk = nnls_cuda.nnls_batch_cuda_batched_packed_t(a_full, packed_t,
                                                        iu, B, X0, **kw)
        Xt = nnls_cuda.nnls_batch_cuda_batched_at(at, B, X0, **kw)
        torch.cuda.synchronize()
        assert torch.equal(Xk, Xt), k
        if k in edges:
            Xp = nnls.nnls_batch(at.permute(2, 1, 0), B, X0, **kw)
            np.testing.assert_allclose(Xk.cpu().numpy(), Xp.cpu().numpy(),
                                       rtol=5e-3, atol=1e-6, err_msg=str(k))


def test_solve_packed_t_reads_the_packed_form(cuda, monkeypatch):
    """On the card solve_nnls_packed_t launches B2's packed entry once,
    runs no plain version and writes no (k, k, n) tile."""
    from singlet_tpu_torch.ops import linalg

    a_full, packed_t, iu, B, X0, mask = _masked_problem_packed(
        333, 20, 5, cuda)
    want = nnls.nnls_batch(
        linalg.unpack_sym_from_t(packed_t, 20, iu, a_full).permute(2, 1, 0),
        B, X0, L1=0.01, update_mask=mask, sweep_cap=32.0)

    def refuse(*args, **kwargs):
        raise AssertionError("unpack_sym_from_t called")

    monkeypatch.setattr(linalg, "unpack_sym_from_t", refuse)
    counts = (nnls_cuda.LAUNCHES_BATCHED, nnls.PLAIN_CALLS)
    X = nnls.solve_nnls_packed_t(a_full, packed_t, iu, B, X0, L1=0.01,
                                 update_mask=mask, sweep_cap=32.0)
    assert (nnls_cuda.LAUNCHES_BATCHED, nnls.PLAIN_CALLS) == (
        counts[0] + 1, counts[1])
    np.testing.assert_allclose(X.cpu().numpy(), want.cpu().numpy(),
                               rtol=5e-3, atol=1e-6)


def test_packed_entry_checks_inputs(cuda):
    a_full, packed_t, iu, B, X0, _ = _masked_problem_packed(64, 6, 6, cuda)
    with pytest.raises(ValueError, match="shape"):
        nnls_cuda.nnls_batch_cuda_batched_packed_t(a_full, packed_t[:-1],
                                                   iu, B, X0)
    with pytest.raises(ValueError, match="contiguous"):
        nnls_cuda.nnls_batch_cuda_batched_packed_t(
            a_full, packed_t.T.contiguous().T, iu, B, X0)
    with pytest.raises(ValueError, match="triu_pairs"):
        nnls_cuda.nnls_batch_cuda_batched_packed_t(
            a_full, packed_t, (iu[1], iu[0]), B, X0)
    k = nnls_cuda.MAX_K_BATCHED + 1
    with pytest.raises(NotImplementedError, match="B2"):
        nnls_cuda.nnls_batch_cuda_batched_packed_t(
            torch.eye(k, device=cuda), torch.ones((k * (k + 1) // 2, 4),
                                                  device=cuda),
            None, torch.ones((4, k), device=cuda),
            torch.zeros((4, k), device=cuda))

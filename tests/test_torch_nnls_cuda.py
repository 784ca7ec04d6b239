"""Kernels B1 and B2 (``singlet_tpu_torch/ops/nnls_cuda.py``) on the card
against their plain PyTorch version on the same inputs.

A CUDA kernel has no CPU mode, so every test here needs a card and skips
without one. On a machine with a card (and without jax, which
``tests/conftest.py`` imports), run:

    python -m pytest --noconftest tests/test_torch_nnls_cuda.py -q

Tolerance rtol=5e-3, atol=1e-6, that of tests/test_pallas_nnls.py: kernel and
plain version round every coordinate step alike, but sum the sweep-end tol in
another order, so a borderline column may run one sweep more or fewer.
B1 and B2 also take an (n, k) L1 (the plain version's per-coordinate
branch); a run gives the same bits every time. A zero Gram diagonal with a
zero right-hand side turns a column NaN on every route, as in the plain
version (the same NaN positions: ``assert_allclose``'s ``equal_nan``).
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
    """Float64 raises rather than run the plain loop on the card; an (n, k)
    L1 goes to B1 with a shared Gram and to B2 with per-column Grams, each
    within the tolerance of the plain version."""
    a, B, X0, _ = _problem(64, 5, 4, cuda)
    with pytest.raises(NotImplementedError):
        nnls.solve_nnls(a.double(), B.double(), X0.double())
    L1 = torch.rand((64, 5), generator=torch.Generator(device=cuda)
                    .manual_seed(4), device=cuda) * 0.05
    grams = a.expand(64, 5, 5).contiguous()
    for g, launches in ((a, "LAUNCHES"), (grams, "LAUNCHES_BATCHED")):
        counts = (getattr(nnls_cuda, launches), nnls.PLAIN_CALLS)
        X = nnls.solve_nnls(g, B, X0, L1=L1)
        assert (getattr(nnls_cuda, launches), nnls.PLAIN_CALLS) == (
            counts[0] + 1, counts[1])
        np.testing.assert_allclose(
            X.cpu().numpy(), nnls.nnls_batch(g, B, X0, L1=L1).cpu().numpy(),
            rtol=5e-3, atol=1e-6)


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


def _scratch_plan(n, k, gram="packed"):
    """The wide-k route with its state in device scratch: two blocks of 8
    warps that take the columns in turn."""
    return nnls_cuda.WidePlan(8, 2, False, 0, 2 * 8 * 8 * k)


def test_kernel_refuses_large_k(cuda, monkeypatch):
    """Past k = 512 B1 takes its wide-k route; it refuses only where device
    memory cannot hold the route's state, naming the bytes."""
    k = nnls_cuda.MAX_K + 1
    a = torch.eye(k, device=cuda)
    B = torch.ones((4, k), device=cuda)
    wide = nnls_cuda.LAUNCHES_WIDE
    X = nnls_cuda.nnls_batch_cuda(a, B, torch.zeros_like(B))
    assert nnls_cuda.LAUNCHES_WIDE == wide + 1
    assert torch.equal(X, nnls.nnls_batch(a, B, torch.zeros_like(B)))
    monkeypatch.setattr(nnls_cuda, "nnls_wide_plan", _scratch_plan)
    monkeypatch.setattr(torch.cuda, "mem_get_info", lambda *a: (0, 1))
    with pytest.raises(RuntimeError, match="B1.*bytes"):
        nnls_cuda.nnls_batch_cuda(a, B, torch.zeros_like(B))


def test_batched_kernel_refuses_large_k(cuda, monkeypatch):
    """Past k = 512 B2 takes its wide-k route; it refuses only where device
    memory cannot hold the route's state, naming the bytes."""
    k = nnls_cuda.MAX_K_BATCHED + 1
    at = torch.eye(k, device=cuda)[:, :, None].repeat(1, 1, 4).contiguous()
    B = torch.ones((4, k), device=cuda)
    wide = nnls_cuda.LAUNCHES_BATCHED_WIDE
    X = nnls_cuda.nnls_batch_cuda_batched_at(at, B, torch.zeros_like(B))
    assert nnls_cuda.LAUNCHES_BATCHED_WIDE == wide + 1
    assert torch.equal(X, nnls.nnls_batch(at.permute(2, 1, 0), B,
                                          torch.zeros_like(B)))
    monkeypatch.setattr(nnls_cuda, "nnls_wide_plan", _scratch_plan)
    monkeypatch.setattr(torch.cuda, "mem_get_info", lambda *a: (0, 1))
    with pytest.raises(RuntimeError, match="B2.*bytes"):
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


def test_packed_entry_checks_inputs(cuda, monkeypatch):
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
    # past k = 512 the wide-k route, which refuses only where device memory
    # cannot hold its state
    from singlet_tpu_torch.ops import linalg

    k = nnls_cuda.MAX_K_BATCHED + 1
    monkeypatch.setattr(nnls_cuda, "nnls_wide_plan", _scratch_plan)
    monkeypatch.setattr(torch.cuda, "mem_get_info", lambda *a: (0, 1))
    with pytest.raises(RuntimeError, match="B2.*bytes"):
        nnls_cuda.nnls_batch_cuda_batched_packed_t(
            torch.eye(k, device=cuda), torch.zeros((k * (k + 1) // 2, 4),
                                                   device=cuda),
            linalg.triu_pairs(k), torch.ones((4, k), device=cuda),
            torch.zeros((4, k), device=cuda))


def _nan_to_zero(x):
    """x with its NaNs (and only those) as 0: with equal NaN masks, two
    results are the same bits where they are numbers."""
    return torch.nan_to_num(x, nan=0.0, posinf=float("inf"),
                            neginf=float("-inf"))


# ---------------------------------------- zero Gram diagonals, (n, k) L1

def _zero_diag_shared(n, k, z, seed, device):
    """A shared Gram whose factor z is zero on every row (row, column and
    diagonal z exactly 0) and B = G F (column z exactly 0: those columns
    turn NaN), but a third of the columns with b_z < 0 (x_z clamps to 0,
    finite); 10% of the columns held."""
    rng = np.random.default_rng(seed)
    m = 2 * k + 8
    F = rng.random((m, k)).astype(np.float32)
    F[:, z] = 0.0
    eye = np.eye(k, dtype=np.float32)
    eye[z, z] = 0.0
    a = (F.T @ F + 1e-15 * eye).astype(np.float32)
    B = (rng.random((n, m)).astype(np.float32) @ F).astype(np.float32)
    B[::3, z] = -0.5
    X0 = (rng.random((n, k)) * (rng.random((n, k)) < 0.5)).astype(np.float32)
    mask = rng.random(n) < 0.9
    return [torch.as_tensor(x, device=device) for x in (a, B, X0, mask)]


def _zero_diag_packed(n, k, z, seed, device):
    """A masked half-update's inputs (a_full, packed_t, iu, B, X0, mask)
    where factor z is nonzero on one row alone, held out for the even
    columns: their Grams have row, column and diagonal z exactly 0 and
    their b_z is exactly 0 (NaN columns); the odd columns stay finite."""
    from singlet_tpu_torch.ops import linalg

    rng = np.random.default_rng(seed)
    m = 2 * k + 8
    F = rng.random((m, k)).astype(np.float32)
    F[:, z] = 0.0
    F[3, z] = 0.75
    held = rng.random((n, m)) < 0.05
    held[:, 3] = np.arange(n) % 2 == 0
    Ft = torch.as_tensor(F, device=device)
    mt = torch.as_tensor(held, device=device)
    iu = linalg.triu_pairs(k)
    packed_t = linalg.mask_dot_t(linalg.packed_outer_products(Ft, iu), mt,
                                 1).contiguous()
    a_full = Ft.T @ Ft + 1e-15 * torch.eye(k, device=device)
    a_full[z, z] = float(np.float32(0.75) * np.float32(0.75))
    kept = torch.as_tensor(np.where(held, 0.0, rng.random((n, m))),
                           dtype=torch.float32, device=device)
    B = kept @ Ft
    X0 = (rng.random((n, k)) * (rng.random((n, k)) < 0.5)).astype(np.float32)
    mask = rng.random(n) < 0.9
    return (a_full.contiguous(), packed_t, iu, B.contiguous(),
            torch.as_tensor(X0, device=device),
            torch.as_tensor(mask, device=device))


def _nan_close(got, want, mask, X0):
    """The plain version's NaN positions and, elsewhere, its values within
    the tolerance; held columns X0 bit for bit."""
    np.testing.assert_allclose(got.cpu().numpy(), want.cpu().numpy(),
                               rtol=5e-3, atol=1e-6, equal_nan=True)
    assert torch.equal(got[~mask], X0[~mask])


@pytest.mark.parametrize("n,k,z", [(300, 9, 4), (1500, 10, 0), (2048, 50, 17),
                                   (1024, 100, 99), (300, 224, 100),
                                   (200, 300, 150)])
def test_b1_zero_diagonal_gives_the_plain_nans(cuda, n, k, z):
    """B1 on its shared-memory (k <= 224) and device-memory routes: the
    columns whose b_z is 0 turn NaN from coordinate z on, as the plain
    version's, the others clamp x_z to 0; with a scalar and an (n, k)
    L1."""
    a, B, X0, mask = _zero_diag_shared(n, k, z, n + k, cuda)
    L1s = (0.01, torch.rand((n, k), generator=torch.Generator(device=cuda)
                            .manual_seed(k), device=cuda) * 0.05)
    for L1 in L1s:
        kw = dict(L1=L1, L2=0.001, update_mask=mask, sweep_cap=8.0)
        Xk = nnls_cuda.nnls_batch_cuda(a, B, X0, **kw)
        Xp = nnls.nnls_batch(a, B, X0, **kw)
        torch.cuda.synchronize()
        assert torch.isnan(Xp[mask]).any(dim=1).sum() > 0
        assert torch.isfinite(Xp[::3]).all()
        _nan_close(Xk, Xp, mask, X0)


@pytest.mark.parametrize("n,k,z", [(256, 9, 3), (1500, 10, 9), (2048, 50, 0),
                                   (1024, 100, 42), (130, 224, 200),
                                   (130, 256, 255), (96, 300, 7),
                                   (64, 400, 321)])
def test_b2_zero_diagonal_gives_the_plain_nans(cuda, n, k, z):
    """B2's packed and tile entries (every layout of the tuned route): the
    columns that hold factor z's only row out turn NaN, as the plain
    version's, the others stay finite; the two entries give the same
    bits."""
    from singlet_tpu_torch.ops import linalg

    a_full, packed_t, iu, B, X0, mask = _zero_diag_packed(n, k, z, n + k,
                                                          cuda)
    at = linalg.unpack_sym_from_t(packed_t, k, iu, a_full)
    kw = dict(L1=0.01, L2=0.001, update_mask=mask, sweep_cap=32.0)
    Xk = nnls_cuda.nnls_batch_cuda_batched_packed_t(a_full, packed_t, iu, B,
                                                    X0, **kw)
    Xt = nnls_cuda.nnls_batch_cuda_batched_at(at, B, X0, **kw)
    Xp = nnls.nnls_batch(at.permute(2, 1, 0), B, X0, **kw)
    torch.cuda.synchronize()
    assert torch.isnan(Xp[0::2][mask[0::2]]).any(dim=1).all()
    assert torch.isfinite(Xp[1::2]).all()
    assert torch.equal(torch.isnan(Xk), torch.isnan(Xt))
    assert torch.equal(_nan_to_zero(Xk), _nan_to_zero(Xt))
    _nan_close(Xk, Xp, mask, X0)


@pytest.mark.parametrize("n,k", [(256, 9), (1500, 10), (2048, 50),
                                 (1024, 100), (130, 224), (130, 256),
                                 (96, 300), (64, 400)])
@pytest.mark.parametrize("sweep_cap", [None, 32.0])
def test_b2_l1_array_matches_plain(cuda, n, k, sweep_cap):
    """B2's packed and tile entries with a per-coordinate (n, k) L1: the
    same bits as each other, within the tolerance of the plain version's
    (n, k) branch, masked columns X0; through solve_nnls_packed_t one
    launch and no plain call."""
    from singlet_tpu_torch.ops import linalg

    a_full, packed_t, iu, B, X0, mask = _masked_problem_packed(
        n, k, n + k + 3, cuda)
    at = linalg.unpack_sym_from_t(packed_t, k, iu, a_full)
    L1 = torch.rand((n, k), generator=torch.Generator(device=cuda)
                    .manual_seed(k), device=cuda) * 0.05
    kw = dict(L1=L1, L2=0.001, update_mask=mask, sweep_cap=sweep_cap)
    counts = (nnls_cuda.LAUNCHES_BATCHED, nnls.PLAIN_CALLS)
    Xk = nnls.solve_nnls_packed_t(a_full, packed_t, iu, B, X0, **kw)
    assert (nnls_cuda.LAUNCHES_BATCHED, nnls.PLAIN_CALLS) == (
        counts[0] + 1, counts[1])
    Xt = nnls_cuda.nnls_batch_cuda_batched_at(at, B, X0, **kw)
    Xp = nnls.nnls_batch(at.permute(2, 1, 0), B, X0, **kw)
    torch.cuda.synchronize()
    assert torch.equal(Xk, Xt)
    np.testing.assert_allclose(Xk.cpu().numpy(), Xp.cpu().numpy(),
                               rtol=5e-3, atol=1e-6)
    assert torch.equal(Xk[~mask], X0[~mask])
    # a scalar L1 spread over (n, k) gives the scalar route's bits
    full = dict(kw, L1=torch.full_like(B, 0.01))
    assert torch.equal(
        nnls_cuda.nnls_batch_cuda_batched_at(at, B, X0, **full),
        nnls_cuda.nnls_batch_cuda_batched_at(at, B, X0, **dict(kw, L1=0.01)))

"""The CD-NNLS kernels' sweep counters (``csrc/nnls_cd.cu``,
``csrc/nnls_cd_batched.cu``, ``csrc/nnls_wide.cuh``) and the spans of a
fit on the card.

A CUDA kernel has no CPU mode, so every test here needs a card and skips
without one. On a machine with a card (and without jax, which
``tests/conftest.py`` imports), run:

    python -m pytest --noconftest tests/test_torch_tracing_cuda.py -q

With the tracing on and the counters armed, each kernel adds the sweeps
its columns ran and the columns its update mask let move; both must equal
the sums of the plain version's ``return_sweeps`` on the CPU, on inputs
where the kernels' X already agrees with the plain version's (the
fixtures of tests/test_torch_nnls_cuda.py and tests/test_torch_wide_cuda.py
at their shapes): B1's tuned routes, B2's tile and packed entries, and
the wide routes (B1's quad and staged kernels, B2's staged kernel, and the
warp-a-column kernel forced by the plan). Where the sums differ, the
failure names the columns whose sweep counts differ, each solved alone.
With the tracing off the same calls give the same bits; a fit gives the
same bits with the tracing on, and the pack's span logs its card time
once the fit's output is on the host.
"""

import numpy as np
import pytest
import scipy.sparse as sp
import torch

from singlet_tpu_torch import tracing
from singlet_tpu_torch.ops import linalg, nnls, nnls_cuda

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


def _masked_problem_packed(n, k, seed, device):
    """A masked half-update's solve: a_full, the packed corrections of each
    column's 5% masked rows, iu, B, a warm X0 and a 90% update mask."""
    g = torch.Generator(device=device).manual_seed(seed)
    rows = max(128, 2 * k)
    F = torch.rand((rows, k), generator=g, device=device)
    iu = linalg.triu_pairs(k)
    m = torch.rand((n, rows), generator=g, device=device) < 0.05
    packed_t = linalg.mask_dot_t(linalg.packed_outer_products(F, iu), m,
                                 1).contiguous()
    a_full = F.T @ F + 1e-15 * torch.eye(k, device=device)
    B = torch.where(m, 0.0, torch.rand((n, rows), generator=g,
                                       device=device)) @ F
    X0 = (torch.rand((n, k), generator=g, device=device)
          * (torch.rand((n, k), generator=g, device=device) < 0.5))
    mask = torch.rand(n, generator=g, device=device) < 0.9
    return a_full, packed_t, iu, B, X0, mask


def _counted(solve, cols):
    """(X, sweeps, columns) of ``solve(cols)`` on the card with the
    counters on and armed."""
    counts = tracing.CdCounts("cuda")
    with tracing.metric_logging(spans=True):
        with counts.armed():
            X = solve(cols)
        _, cd = counts.read(torch.zeros((), device="cuda"))
    route = "B1" if cd["cd_columns"]["B1"] else "B2"
    other = "B2" if route == "B1" else "B1"
    assert cd["cd_sweeps"][other] == cd["cd_columns"][other] == 0
    return X, cd["cd_sweeps"][route], cd["cd_columns"][route]


def _check(solve, plain, n):
    """The kernel's counts against the CPU plain version's sums; on a
    difference, the columns whose sweeps differ, each solved alone. Also:
    the counted call gives the bits of an uncounted one."""
    all_ = torch.arange(n)
    X, sweeps, columns = _counted(solve, all_)
    assert torch.equal(X, solve(all_))
    _, sw = plain(all_)
    if (sweeps, columns) != (int(sw.sum()), int((sw > 0).sum())):
        differ = []
        for c in range(n):
            one = torch.tensor([c])
            got = _counted(solve, one)[1]
            want = int(plain(one)[1].sum())
            if got != want:
                differ.append((c, got, want))
        pytest.fail(f"kernel {sweeps} sweeps over {columns} columns, plain "
                    f"{int(sw.sum())} over {int((sw > 0).sum())}; columns "
                    f"(id, kernel, plain) whose sweeps differ: {differ}")


def _cpu(*xs):
    return [x.cpu() for x in xs]


@pytest.mark.parametrize("n,k,cap", [(2048, 50, None), (1024, 100, 8.0),
                                     (300, 224, None), (200, 300, 8.0)])
def test_b1_counts_match_plain(cuda, n, k, cap):
    a, B, X0, mask = _problem(n, k, n + k, cuda)
    kw = dict(L1=0.01, L2=0.001, sweep_cap=cap)

    def solve(c):
        c = c.to(cuda)
        return nnls_cuda.nnls_batch_cuda(a, B[c].contiguous(),
                                         X0[c].contiguous(),
                                         update_mask=mask[c], **kw)

    def plain(c):
        c = c.to(cuda)
        return nnls.nnls_batch(*_cpu(a, B[c], X0[c]),
                               update_mask=mask[c].cpu(),
                               return_sweeps=True, **kw)
    _check(solve, plain, n)


@pytest.mark.parametrize("entry", ["tile", "packed"])
@pytest.mark.parametrize("n,k", [(1500, 10), (2048, 50), (1024, 100),
                                 (130, 150), (96, 300), (64, 400)])
def test_b2_counts_match_plain(cuda, entry, n, k):
    a_full, packed_t, iu, B, X0, mask = _masked_problem_packed(n, k, k,
                                                               cuda)
    at = linalg.unpack_sym_from_t(packed_t, k, iu, a_full)
    kw = dict(L1=0.01, L2=0.001, sweep_cap=32.0)

    def solve(c):
        c = c.to(cuda)
        args = (B[c].contiguous(), X0[c].contiguous())
        if entry == "tile":
            return nnls_cuda.nnls_batch_cuda_batched_at(
                at[:, :, c].contiguous(), *args, update_mask=mask[c], **kw)
        return nnls_cuda.nnls_batch_cuda_batched_packed_t(
            a_full, packed_t[:, c].contiguous(), iu, *args,
            update_mask=mask[c], **kw)

    def plain(c):
        c = c.to(cuda)
        return nnls.nnls_batch(*_cpu(at[:, :, c].permute(2, 1, 0), B[c],
                                     X0[c]), update_mask=mask[c].cpu(),
                               return_sweeps=True, **kw)
    _check(solve, plain, n)


def _warp_plan(n, k, gram="packed"):
    """The warp-a-column kernel, its state in shared memory."""
    return nnls_cuda.WidePlan(8, -(-n // 8), True, 8 * 8 * k, 0)


@pytest.mark.parametrize("n,k,route", [(257, 600, "quad"),
                                       (24, 4100, "staged"),
                                       (100, 600, "warp")])
def test_b1_wide_counts_match_plain(cuda, monkeypatch, n, k, route):
    if route == "warp":
        monkeypatch.setattr(nnls_cuda, "nnls_wide_plan", _warp_plan)
    a, B, X0, mask = _problem(n, k, n + k, cuda)
    kw = dict(L1=0.01, L2=0.001, sweep_cap=8.0)

    def solve(c):
        c = c.to(cuda)
        wide = nnls_cuda.LAUNCHES_WIDE
        X = nnls_cuda.nnls_batch_cuda(a, B[c].contiguous(),
                                      X0[c].contiguous(),
                                      update_mask=mask[c], **kw)
        assert nnls_cuda.LAUNCHES_WIDE == wide + 1
        return X

    def plain(c):
        c = c.to(cuda)
        return nnls.nnls_batch(*_cpu(a, B[c], X0[c]),
                               update_mask=mask[c].cpu(),
                               return_sweeps=True, **kw)
    _check(solve, plain, n)


@pytest.mark.parametrize("n,k,route", [(130, 600, "staged"),
                                       (66, 700, "warp")])
def test_b2_wide_counts_match_plain(cuda, monkeypatch, n, k, route):
    if route == "warp":
        monkeypatch.setattr(nnls_cuda, "nnls_wide_plan", _warp_plan)
    a_full, packed_t, iu, B, X0, mask = _masked_problem_packed(n, k, k,
                                                               cuda)
    at = linalg.unpack_sym_from_t(packed_t, k, iu, a_full)
    kw = dict(L1=0.01, L2=0.001, sweep_cap=32.0)

    def solve(c):
        c = c.to(cuda)
        return nnls_cuda.nnls_batch_cuda_batched_packed_t(
            a_full, packed_t[:, c].contiguous(), iu, B[c].contiguous(),
            X0[c].contiguous(), update_mask=mask[c], **kw)

    def plain(c):
        c = c.to(cuda)
        return nnls.nnls_batch(*_cpu(at[:, :, c].permute(2, 1, 0), B[c],
                                     X0[c]), update_mask=mask[c].cpu(),
                               return_sweeps=True, **kw)
    _check(solve, plain, n)


def _fit(P, masked):
    from singlet_tpu_torch.solvers import drivers

    if masked:
        df = drivers.cross_validate_nmf(P, [6], n_replicates=1, tol=0.0,
                                        maxit=4, trace_test_mse=2,
                                        verbose=0)
        return [df[c].to_numpy() for c in df.columns]
    m = drivers.run_nmf(P, 6, tol=0.0, maxit=4)
    return [m.w, m.d, m.h]


@pytest.mark.parametrize("masked", [False, True])
def test_engine_fit_same_bits_with_spans(cuda, masked):
    """The engine's fit on the card (the bits route when masked) gives the
    same bits with the tracing on; each iteration counts its solves (on
    the plain fit B1's columns: the nonempty cells and genes), and the
    pack's span logs its card time after the output span."""
    from singlet_tpu_torch.parallel.sharded_ell import ShardedEllEngine

    A = sp.random(700, 3000, density=0.05, random_state=3, format="csc",
                  dtype=np.float32)
    A.data = np.abs(A.data) + 0.1
    eng = ShardedEllEngine(A, device="cuda", cell_block=256, gene_block=256)
    with tracing.metric_logging() as off_log:
        off = _fit(eng, masked)
    with tracing.metric_logging(spans=True) as on_log:
        on = _fit(eng, masked)
    for x, y in zip(off, on):
        np.testing.assert_array_equal(x, y)
    its = [e for e in on_log.events if e["event"] == "iteration"]
    assert [e["tol"] for e in its] == [
        e["tol"] for e in off_log.events if e["event"] == "iteration"]
    route = "B2" if masked else "B1"
    for e in its:
        assert e["cd_sweeps"][route] >= e["cd_columns"][route] > 0
        if not masked:
            assert e["cd_columns"]["B1"] == int(eng.data.nonempty.sum()) \
                + int(eng.data.gene_nonempty.sum())
    names = [e["name"] for e in on_log.events if e["event"] == "span"]
    if masked:
        pack = [e for e in on_log.events if e.get("name") == "singlet.pack"]
        assert len(pack) == 1 and pack[0]["device_ms"] > 0
        assert names.index("singlet.pack") > names.index("singlet.output")
    else:
        assert "singlet.pack" not in names

"""The frozen rules and generators of the benchmark against the program's
own versions and the operands they copy, at tiny sizes on the CPU."""

import pytest
import torch

from conftest import BENCH_DIR
from portbench import reference as ref
from portbench import registry

bell = registry.plugin(BENCH_DIR, "operands", "bell_closed_form")
dense = registry.plugin(BENCH_DIR, "operands", "dense_uniform")


def test_bell_planes_seed0_is_the_largescale_operand():
    import chip_smoke

    li, lv, w = bell.bell_planes(2048, 3000, 100, 512, 0, "cpu",
                                     chunk=1024)
    li0, lv0, w0 = chip_smoke.synth_bell_planes_torch(2048, 3000, 100, 512,
                                                      device="cpu",
                                                      chunk=1024)
    assert w == w0
    assert torch.equal(li, li0) and torch.equal(lv, lv0)


def test_bell_planes_seed_changes_values_not_shapes():
    a = bell.bell_planes(2048, 512, 100, 512, 5, "cpu")
    b = bell.bell_planes(2048, 512, 100, 512, 6, "cpu")
    assert a[0].shape == b[0].shape and a[2] == b[2]
    assert torch.equal(a[0] >= 0, b[0] >= 0)       # the same stored slots
    assert not torch.equal(a[1], b[1])
    live = a[0] >= 0
    assert float(a[1][live].min()) >= 0.1 and float(a[1][live].max()) < 1.1
    # genes within a gene block are distinct in a cell (no gene held twice)
    li = a[0].reshape(4, -1, 512)
    for gb in range(4):
        col = li[gb][:, 7]
        col = col[col >= 0]
        assert len(set(col.tolist())) == len(col)


def test_dense_uniform_matches_bench_definition():
    # bench.py:100-121 and chip_smoke._bench_operand: 7% of entries kept,
    # values U(0.1, 3.0)
    A = dense.dense_uniform(512, 256, 0.07, 0.1, 3.0, 42, "cpu")
    kept = A[A != 0]
    assert abs(kept.numel() / A.numel() - 0.07) < 0.01
    assert float(kept.min()) >= 0.1 and float(kept.max()) < 3.0
    B = dense.dense_uniform(512, 256, 0.07, 0.1, 3.0, 42, "cpu")
    assert torch.equal(A, B)


def test_mask_rule_matches_the_program():
    from singlet_tpu_torch.ops.rngmask import mask_block, seed_pair

    cells = torch.arange(1000, 1300)
    genes = torch.arange(0, 700)
    for seed in (1, 2**31 + 17, 3 * 2**40 + 5):
        want = mask_block(seed_pair(seed), cells, genes, 20)
        assert torch.equal(ref.mask_block(seed, cells, genes, 20), want)


def test_init_rule_matches_the_program():
    from singlet_tpu_torch.solvers.als import init_w

    for seed in (0, 7, 123456789012):
        assert torch.equal(ref.init_w(6, 40, 37, seed, "cpu"),
                           init_w(6, 40, 37, seed, device="cpu"))


def test_quantize_matches_the_program():
    from singlet_tpu_torch.ops.maskgram import quantize_pairs

    P = torch.randn(300, 55, generator=torch.Generator().manual_seed(3))
    q, s = quantize_pairs(P, axis=0)
    rq, rs = ref.quantize(P, 127, axis=0)
    assert torch.equal(rq, q.to(rq.dtype)) and torch.equal(rs, s)


def test_sweep_cap_matches_the_schedule():
    from singlet_tpu_torch.ops.nnls import SweepSettings, sweep_cap_update

    tols = [0.5, 0.01, 2e-3, 9e-5, 2e-4, 1e-6]
    for masked in (False, True):
        exact = False
        prev = 1.0
        for j, t in enumerate(tols):
            cap, exact = sweep_cap_update(exact, prev, 1e-5, masked=masked,
                                          settings=SweepSettings())
            assert ref.sweep_cap(tols[:j], 1e-5, masked) == cap
            prev = t


@pytest.mark.parametrize("batched", [False, True])
@pytest.mark.parametrize("cap", [3.0, 100.0])
def test_cd_nnls_matches_the_plain_version(batched, cap):
    from singlet_tpu_torch.ops.nnls import nnls_batch

    g = torch.Generator().manual_seed(11)
    n, k = 64, 7
    X = torch.rand(200, k, generator=g)
    a = X.T @ X + 0.1 * torch.eye(k)
    if batched:
        a = a[None] + 0.05 * torch.rand(n, k, k, generator=g)
        a = (a + a.transpose(1, 2)) / 2
    B = torch.rand(n, k, generator=g) * 10
    X0 = torch.rand(n, k, generator=g)
    mask = torch.rand(n, generator=g) > 0.1
    want = nnls_batch(a, B, X0, L1=0.01, update_mask=mask, sweep_cap=cap)
    got = ref.cd_nnls(a.double(), B.double(), X0.double(), 0.01, cap,
                      update_mask=mask)
    assert torch.allclose(got, want.double(), rtol=1e-4, atol=1e-6)
    assert torch.equal(got[~mask], X0[~mask].double())


def test_tf32_round():
    x = torch.tensor([1.0, 1.0 + 2**-11, 1.0 + 3 * 2**-11, 3.14159265])
    r = ref.tf32_round(x)
    assert r[0] == 1.0
    assert r[1] == 1.0                  # a tie goes to even
    assert r[2] == 1.0 + 2**-9          # a tie goes to even, upward
    assert abs(float(r[3]) - 3.14159265) <= 2**-10 * 2
    assert (r.view(torch.int32) & 0x1FFF).eq(0).all()


def test_masked_step_halves_match_the_port_on_the_cpu():
    """One masked step of the port's dense providers (f32 mask products)
    against the reference's half-updates, all columns."""
    from singlet_tpu_torch.solvers.als import (als_step_masked,
                                               make_dense_providers)
    from singlet_tpu_torch.ops.rngmask import seed_pair

    A = dense.dense_uniform(80, 48, 0.3, 0.1, 3.0, 9, "cpu")
    Ap, Atp = make_dense_providers(A.numpy(), device="cpu")
    W0 = ref.init_w(5, Ap.rows_pad, 80, 4, "cpu")
    H0 = torch.zeros(Ap.cols_pad, 5)
    W, H, d, _ = als_step_masked(Ap, Atp, W0, H0, seed_pair(7), 0.01, 0.0,
                                 20, Ap.block, Atp.block, sweep_cap=32.0)
    op = ref.DenseOperand(Ap.data, 80, 48)
    spec = ref.StepSpec(L1_h=0.01, L1_w=0.01, cap=32.0, masked=True,
                        mask_seed=7, inv_density=20)
    cells = torch.arange(op.cells_pad)
    genes = torch.arange(op.genes_pad)
    h = ref.h_half(op, W0, H0, cells, spec, ref.Precision())
    w = ref.w_half(op, H, W0, genes, spec, ref.Precision())
    hn = h / h.sum(dim=0)
    assert torch.allclose(H.double(), hn, rtol=1e-4, atol=1e-7)
    assert torch.allclose((W * d[None]).double(), w, rtol=1e-4, atol=1e-6)


def test_test_mse_matches_the_port_on_the_cpu():
    from singlet_tpu_torch.solvers.als import make_dense_providers, mse_test
    from singlet_tpu_torch.ops.rngmask import seed_pair

    A = dense.dense_uniform(80, 48, 0.3, 0.1, 3.0, 9, "cpu")
    Ap, _ = make_dense_providers(A.numpy(), device="cpu")
    g = torch.Generator().manual_seed(2)
    W = torch.rand(Ap.rows_pad, 5, generator=g)
    H = torch.rand(Ap.cols_pad, 5, generator=g)
    d = torch.rand(5, generator=g)
    want = float(mse_test(Ap, W, d, H, seed_pair(3), 20, Ap.block))
    op = ref.DenseOperand(Ap.data, 80, 48)
    got = ref.test_mse(op, W, d, H, 3, 20, ref.Precision())
    assert abs(got - want) <= 1e-6 * want


def test_tol_rule_matches_the_port():
    from singlet_tpu_torch.ops.linalg import cor_distance

    g = torch.Generator().manual_seed(5)
    W0 = torch.rand(300, 7, generator=g, dtype=torch.float64)
    for eps in (1e-1, 1e-2, 1e-3):
        W1 = W0 * (1 + eps * torch.randn(300, 7, generator=g,
                                         dtype=torch.float64))
        want = float(cor_distance(W1, W0))
        got = ref.cor_distance(W1, W0, ref.Precision())
        assert abs(got - want) <= 1e-9 * want


def _fake_fit(tols, errs=None):
    """A step whose tols (and a test MSE whose errors) follow the lists."""
    it = iter(tols)
    et = iter(errs or [])
    W = torch.ones(4, 2)

    def step(W, H, cap):
        return W, H, torch.ones(2), torch.tensor(next(it))

    def mse(W, d, H):
        return torch.tensor(next(et))
    return step, mse, W


@pytest.mark.parametrize("tols, maxit", [
    ([0.5, 1e-3, 2e-5, 9e-6, 1e-6], 10),     # stops by tol at step 4
    ([0.5, 1e-3, 2e-5, 3e-5, 4e-5], 4),      # stops at maxit
    ([0.5, 1e-5], 10),                       # a tol equal to the target
])
def test_plain_stop_rule_matches_the_port(tols, maxit):
    from singlet_tpu_torch.solvers.als import SweepSettings, _fit_loop
    from portbench.judge import FitRules, replay_steps

    step, _, W = _fake_fit(tols)
    _, _, _, trace = _fit_loop(step, W, W, 1e-5, maxit, SweepSettings())
    rules = FitRules(masked=False, k=2, k_top=2, init_seed=0, tol=1e-5,
                     L1=0.01, maxit=maxit)
    its = [{"tol": t} for t in trace]
    assert replay_steps(rules, its) == len(trace)
    # the same trace cut one step short would have gone on
    if len(trace) > 1 and trace[-2] > 1e-5:
        assert replay_steps(rules, its[:-1]) == len(trace)


@pytest.mark.parametrize("errs", [
    [1.0, 0.9, 0.8, 0.7],            # falls: runs to maxit
    [1.0, 0.9, 0.95, 0.7],           # rises at the third trace: stops
    [1.0, 1.00005, 1.2],             # a rise under the threshold, then over
])
def test_masked_stop_rule_matches_the_port(errs):
    from singlet_tpu_torch.solvers.als import SweepSettings
    from singlet_tpu_torch.solvers.ard import _ard_loop
    from portbench.judge import FitRules, replay_steps

    maxit, every = 2 * len(errs), 2
    tols = [0.5 / (i + 1) for i in range(maxit)]
    from singlet_tpu_torch import tracing
    from portbench.tap import Events

    step, mse, W = _fake_fit(tols, errs)
    events = Events()
    prev = tracing.set_metric_logger(events)
    try:
        _ard_loop(step, mse, W, W, 1e-5, 1e-4, maxit, every,
                  SweepSettings(), fit_id="f")
    finally:
        tracing.set_metric_logger(prev)
    its = [e for e in events.events if e["event"] == "iteration"]
    rules = FitRules(masked=True, k=2, k_top=2, init_seed=0, tol=1e-5,
                     L1=0.01, maxit=maxit, mask_seed=1, inv_density=20,
                     trace_every=every, overfit=1e-4)
    assert replay_steps(rules, its) == len(its)

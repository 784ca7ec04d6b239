"""Spans and CD-NNLS sweep counters of the port (``singlet_tpu_torch/
tracing.py``), on the CPU.

The gate (``tracing.enabled``) is off by default: then no span event is
logged, no profiler record function is entered and the kernels' wrappers hand
over a null counter. On, through ``metric_logging(spans=True)`` or a
running ``torch.profiler``: the spans nest under the driver call whose id
the fits' ``fit_start`` events carry, every span name reaches the
profiler's host events, the plain CD-NNLS adds the sweeps that
``nnls_batch(..., return_sweeps=True)`` returns, and every result equals
the gate-off fit's bit for bit. The ELL engine runs its f32 route and its
bits route (forced by patching ``sharded_ell._kernel_device``, so that
the plain versions of B5-B9 run and the test mask is packed).
"""

import json

import numpy as np
import pytest
import scipy.sparse as sp
import torch

from singlet_tpu_torch import tracing
from singlet_tpu_torch.ops import linalg, nnls, nnls_cuda
from singlet_tpu_torch.parallel import sharded_ell as tell
from singlet_tpu_torch.solvers import drivers
from singlet_tpu_torch.solvers.ard import ard_nmf_fit

GENES, CELLS, K = 120, 300, 4
PARENTS = {"singlet.driver": None, "singlet.setup": "singlet.driver",
           "singlet.iter": "singlet.driver",
           "singlet.output": "singlet.driver",
           "singlet.finalize": "singlet.driver",
           "singlet.step": "singlet.iter", "singlet.sync": "singlet.iter",
           "singlet.test_mse": "singlet.iter",
           "singlet.pack": "singlet.setup"}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One torch intra-op thread in this module: the suite runs one worker
    process per core, and a thread pool per worker oversubscribes them."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _operand():
    rng = np.random.default_rng(5)
    W = rng.gamma(0.5, 1.0, (GENES, K)).astype(np.float32)
    H = rng.gamma(0.5, 1.0, (K, CELLS)).astype(np.float32)
    A = np.log1p(rng.poisson(W @ H).astype(np.float32))
    return A * (rng.random(A.shape) < 0.4)


def _backend(kind, monkeypatch):
    """The driver's input: dense numpy, or the ELL engine on its f32 route
    or on its bits route."""
    A = _operand()
    if kind == "dense":
        return A
    if kind == "bits":
        monkeypatch.setattr(tell, "_kernel_device", lambda device: True)
    return tell.ShardedEllEngine(sp.csc_matrix(A), device="cpu",
                                 cell_block=256, gene_block=64)


def _call(driver, P):
    """One driver call: a plain fit or a masked one, with a traced test
    error and a tail trace."""
    if driver == "run_nmf":
        m = drivers.run_nmf(P, K, tol=0.0, maxit=4, device="cpu")
        return dict(w=m.w, d=m.d, h=m.h)
    df = drivers.cross_validate_nmf(P, [K], n_replicates=1, tol=0.0,
                                    maxit=4, trace_test_mse=3, verbose=0,
                                    device="cpu")
    return {c: df[c].to_numpy() for c in df.columns}


CASES = [("run_nmf", "dense"), ("cross_validate_nmf", "dense"),
         ("run_nmf", "f32"), ("cross_validate_nmf", "bits")]


def _spans(events):
    return [e for e in events if e["event"] == "span"]


def test_gate_follows_profiler_and_logger():
    assert not tracing.enabled()
    with tracing.metric_logging():
        assert not tracing.enabled()
    with tracing.metric_logging(spans=True):
        assert tracing.enabled()
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU]):
        assert tracing.enabled()
    assert not tracing.enabled()


@pytest.mark.parametrize("driver,kind", CASES)
def test_gate_off_logs_no_span_and_enters_no_record_function(
        monkeypatch, driver, kind):
    P = _backend(kind, monkeypatch)

    def refuse(*a, **k):
        raise AssertionError("record_function entered with the gate off")
    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    monkeypatch.setattr(tracing, "_RecordFunction", refuse)
    with tracing.metric_logging() as logger:
        _call(driver, P)
    assert _spans(logger.events) == []
    its = [e for e in logger.events if e["event"] == "iteration"]
    assert its and not any("cd_sweeps" in e for e in its)
    assert not any("call" in e for e in logger.events)


def test_gate_off_kernels_get_a_null_counter():
    """The wrappers' pointer is null unless the gate is on and a fit loop
    armed the counters on the call's device, and null again after."""
    B = torch.ones((3, 2))
    counts = tracing.CdCounts("cpu")
    with counts.armed():
        assert nnls_cuda._counts("B1", B) is None
    with tracing.metric_logging(spans=True):
        assert nnls_cuda._counts("B1", B) is None
        with counts.armed():
            ptr = nnls_cuda._counts("B2", B)
            assert ptr == counts.total.data_ptr() + 16
            assert tracing.cd_counter("B2", torch.device("meta")) is None
        assert nnls_cuda._counts("B1", B) is None


@pytest.mark.parametrize("driver,kind", CASES)
def test_spans_nest_under_the_driver_call(monkeypatch, driver, kind):
    P = _backend(kind, monkeypatch)
    with tracing.metric_logging(spans=True) as logger:
        _call(driver, P)
        _call(driver, P)
    starts = [e for e in logger.events if e["event"] == "fit_start"]
    spans = _spans(logger.events)
    drivers_ = [s for s in spans if s["name"] == "singlet.driver"]
    assert len(starts) == len(drivers_) == 2
    assert [s["call"] for s in starts] == [d["call"] for d in drivers_]
    assert starts[0]["call"] != starts[1]["call"]
    for s in spans:
        assert s["parent"] == PARENTS[s["name"]], s
        assert s["call"] in (starts[0]["call"], starts[1]["call"])
        assert s["ms"] >= 0 and "device_ms" not in s
    for d in drivers_:
        mine = [s for s in spans if s["call"] == d["call"]
                and s["parent"] == "singlet.driver"]
        # each ms is rounded to 1 us
        assert d["ms"] + 1e-3 * len(mine) >= sum(s["ms"] for s in mine)
    names = {s["name"] for s in spans}
    n_iter = sum(e["event"] == "iteration" for e in logger.events)
    assert sum(s["name"] == "singlet.iter" for s in spans) == n_iter
    assert sum(s["name"] == "singlet.step" for s in spans) == n_iter
    assert sum(s["name"] == "singlet.output" for s in spans) == 2
    assert ("singlet.test_mse" in names) == (driver != "run_nmf")
    assert ("singlet.pack" in names) == (kind == "bits")


@pytest.mark.parametrize("driver,kind", [("cross_validate_nmf", "dense"),
                                         ("cross_validate_nmf", "bits")])
def test_profiler_trace_holds_every_span(monkeypatch, driver, kind):
    """A CPU profiler turns the spans on; each is a host event of its
    trace, where the benchmark's idle-gap naming finds it, and none is a
    user annotation, which a CUDA trace would mirror as a device event."""
    from torch.profiler import ProfilerActivity, profile

    P = _backend(kind, monkeypatch)
    with tracing.metric_logging() as logger:
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            _call(driver, P)
            _call("run_nmf", P)
    events = prof.profiler.kineto_results.events()
    host = {e.name() for e in events}
    assert not any(e.is_user_annotation() for e in events
                   if e.name().startswith("singlet."))
    want = set(PARENTS) - ({"singlet.pack"} if kind != "bits" else set())
    assert want <= host
    assert {s["name"] for s in _spans(logger.events)} == want


def _masked_fit(P):
    """One masked fit's W, d, H and traces (``ard_nmf_fit`` or the
    engine's ``ard_fit``), a test error traced every other iteration."""
    kw = dict(tol=0.0, maxit=5, trace_test_mse=2, overfit_threshold=1.0,
              mask_seed=3)
    if isinstance(P, tell.ShardedEllEngine):
        res = P.ard_fit(K, **kw)
    else:
        res = ard_nmf_fit(P, K, device="cpu", **kw)
    return {f: np.asarray(getattr(res, f)) for f in (
        "w", "d", "h", "test_mse", "iter", "tol", "score_overfit")}


@pytest.mark.parametrize("driver,kind", CASES + [("ard_fit", "dense"),
                                                 ("ard_fit", "bits")])
def test_results_equal_with_the_gate_on(monkeypatch, driver, kind):
    P = _backend(kind, monkeypatch)
    fit = _masked_fit if driver == "ard_fit" else (lambda P: _call(driver, P))
    with tracing.metric_logging() as off_log:
        off = fit(P)
    with tracing.metric_logging(spans=True) as on_log:
        on = fit(P)
    assert off.keys() == on.keys()
    for key in off:
        np.testing.assert_array_equal(on[key], off[key], err_msg=key)

    def traces(log):
        return [(e["tol"], e.get("test_mse")) for e in log.events
                if e["event"] == "iteration"]
    assert traces(on_log) == traces(off_log)


class _SweepSums:
    """``nnls.nnls_batch`` wrapped to add each call's
    ``return_sweeps=True`` sums by route."""

    def __init__(self, monkeypatch):
        self.sweeps = {"B1": 0, "B2": 0}
        self.cols = {"B1": 0, "B2": 0}
        orig = nnls.nnls_batch

        def counted(a, B, X0, *args, return_sweeps=False, **kw):
            X, sw = orig(a, B, X0, *args, return_sweeps=True, **kw)
            route = "B2" if a.dim() == 3 else "B1"
            self.sweeps[route] += int(sw.sum())
            self.cols[route] += int((sw > 0).sum())
            return (X, sw) if return_sweeps else X
        monkeypatch.setattr(nnls, "nnls_batch", counted)


@pytest.mark.parametrize("driver,kind", CASES)
def test_cpu_counts_are_the_return_sweeps_sums(monkeypatch, driver, kind):
    P = _backend(kind, monkeypatch)
    sums = _SweepSums(monkeypatch)
    with tracing.metric_logging(spans=True) as logger:
        _call(driver, P)
    its = [e for e in logger.events if e["event"] == "iteration"]
    got_s = {r: sum(e["cd_sweeps"][r] for e in its) for r in ("B1", "B2")}
    got_c = {r: sum(e["cd_columns"][r] for e in its) for r in ("B1", "B2")}
    route = "B1" if driver == "run_nmf" else "B2"
    assert got_s[route] > 0 and got_c[route] > 0
    # the masked fits' test MSEs and the driver's own work solve nothing
    assert got_s == sums.sweeps and got_c == sums.cols


def test_solves_count_by_route():
    """Each dispatcher adds to its route's counters what the plain
    version's ``return_sweeps`` gives: columns held by the update mask
    count for nothing."""
    g = torch.Generator().manual_seed(3)
    n, k = 40, 6
    F = torch.rand((12, k), generator=g)
    a = F.T @ F
    B = torch.rand((n, 12), generator=g) @ F
    X0 = torch.zeros((n, k))
    mask = torch.rand(n, generator=g) < 0.7
    iu = linalg.triu_pairs(k)
    packed_t = 0.1 * linalg.packed_outer_products(
        torch.rand((n, k), generator=g), iu).T.contiguous()
    at = linalg.unpack_sym_from_t(packed_t, k, iu, a)
    kw = dict(L1=0.01, update_mask=mask, sweep_cap=20.0)
    counts = tracing.CdCounts("cpu")
    with tracing.metric_logging(spans=True):
        with counts.armed():
            nnls.solve_nnls(a, B, X0, **kw)
            nnls.solve_nnls_packed_t(a, packed_t, iu, B, X0, **kw)
            nnls.solve_nnls(at.permute(2, 1, 0), B, X0, **kw)
        (t,), cd = counts.read(torch.tensor(0.25))
    _, s1 = nnls.nnls_batch(a, B, X0, return_sweeps=True, **kw)
    _, s2 = nnls.nnls_batch(at.permute(2, 1, 0), B, X0, return_sweeps=True,
                            **kw)
    assert t == 0.25
    assert cd["cd_sweeps"] == {"B1": int(s1.sum()), "B2": 2 * int(s2.sum())}
    assert cd["cd_columns"] == {"B1": int(mask.sum()),
                                "B2": 2 * int(mask.sum())}
    assert int(s1.sum()) > int(mask.sum())


def test_counts_read_in_one_exact_sync():
    """Off, ``read`` is the loops' old read; on, the float32 scalars come
    back exact beside the counts, and each read gives the counts since the
    last one."""
    t = torch.tensor(np.float32(0.1234567))
    e = torch.tensor(np.float32(3.3e-7))
    counts = tracing.CdCounts("cpu")
    with counts.armed():
        pass
    assert counts.read(t) == ([t.item()], {})
    assert counts.read(t, e) == (torch.stack([t, e]).tolist(), {})
    with tracing.metric_logging(spans=True):
        for step in (1, 2):
            with counts.armed():
                tracing.cd_counter("B1", torch.device("cpu")).add_(
                    torch.tensor([10 * step, step]))
            vals, cd = counts.read(t, e)
            assert vals == torch.stack([t, e]).tolist()
            assert cd == {"cd_sweeps": {"B1": 10 * step, "B2": 0},
                          "cd_columns": {"B1": step, "B2": 0}}


def test_device_span_off_the_card_logs_at_its_end():
    """A span given a CPU device times nothing on a card: it logs at its
    end, with no ``device_ms``."""
    with tracing.metric_logging(spans=True) as logger:
        with tracing.span("outer"):
            with tracing.span("inner", device=torch.device("cpu")):
                pass
            assert [e["name"] for e in _spans(logger.events)] == ["inner"]
    inner, outer = _spans(logger.events)
    assert inner["parent"] == "outer" and outer["parent"] is None
    assert inner["call"] == outer["call"] and "device_ms" not in inner


def test_span_events_reach_the_jsonl_file(tmp_path):
    path = str(tmp_path / "m.jsonl")
    with tracing.metric_logging(path, spans=True) as logger:
        drivers.run_nmf(_operand(), K, tol=0.0, maxit=2, device="cpu")
        n = len(logger.events)
    with open(path) as f:
        lines = [json.loads(line) for line in f]
    assert len(lines) == n
    assert {e["name"] for e in lines if e["event"] == "span"} == {
        "singlet.driver", "singlet.setup", "singlet.iter", "singlet.step",
        "singlet.sync", "singlet.output", "singlet.finalize"}

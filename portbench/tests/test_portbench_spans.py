"""The readers of the program's own spans and counters: ``edge_ms``,
``dispatch_ms``, ``pack_ms``, ``cd_sweeps`` and ``cd_roofline``, on runs
made of known events, and on the events of the program's tiny fits on
the CPU with its spans on. Each reads nothing, and raises nothing, where
the events or the device trace are missing (a program without the spans
and counters, or an untraced run)."""

import types

import numpy as np
import pytest
import torch

from portbench import devtrace, harness, registry, roofline
from conftest import BENCH_DIR

READERS = ("edge_ms.fit", "dispatch_ms.iter", "pack_ms.masked",
           "cd_sweeps.masked", "cd_roofline.fit")


def _read(name, run):
    return registry.metric_module(BENCH_DIR, name).read(run)


def _span(name, call, ms, t, **fields):
    return dict(event="span", name=name, parent=None, call=call, ms=ms, t=t,
                **fields)


def _iteration(fit, t, b1=(0, 0), b2=(0, 0)):
    return dict(event="iteration", fit=fit, t=t, ms=1.0, iter=1, tol=0.5,
                cd_sweeps={"B1": b1[0], "B2": b2[0]},
                cd_columns={"B1": b1[1], "B2": b2[1]})


def _run(calls, t_end, kernels=None, profile=None):
    return harness.Run("c", {}, {"args": {}},
                       [harness.Call(i, 0.0, 1.0, evs)
                        for i, evs in enumerate(calls)],
                       0.0, t_end, kernels, profile)


def test_edge_ms_is_the_mean_output_and_finalize_a_fit():
    calls = [
        [_span("singlet.output", "a", 4.0, 1.0),
         _span("singlet.finalize", "a", 2.0, 1.1),
         _span("singlet.step", "a", 9.0, 0.5)],
        [_span("singlet.output", "b", 10.0, 2.0),
         _span("singlet.finalize", "b", 0.5, 2.1)],
        # the last call's edge came after the window closed
        [_span("singlet.iter", "c", 3.0, 2.5),
         _span("singlet.output", "c", 99.0, 9.0)],
    ]
    assert _read("edge_ms.iter", _run(calls, 3.0)) == pytest.approx(8.25)
    # a call whose output span the window lacks counts for nothing
    calls[1] = calls[1][1:]
    assert _read("edge_ms.iter", _run(calls, 3.0)) == pytest.approx(6.0)


def test_dispatch_ms_is_the_mean_step():
    calls = [[_span("singlet.step", "a", 2.0, 1.0),
              _span("singlet.sync", "a", 50.0, 1.1),
              _span("singlet.step", "a", 4.0, 2.0)],
             [_span("singlet.step", "b", 6.0, 2.5),
              _span("singlet.step", "b", 100.0, 4.0)]]
    assert _read("dispatch_ms.fit", _run(calls, 3.0)) == pytest.approx(4.0)


def test_pack_ms_is_the_mean_device_time_of_the_packs():
    calls = [[_span("singlet.pack", "a", 30.0, 1.0, device_ms=10.0)],
             [_span("singlet.pack", "b", 30.0, 9.0, device_ms=20.0),
              _span("singlet.pack", "b", 1.0, 9.5)]]
    # a pack that began in the window logs at its fit's end, maybe after
    assert _read("pack_ms.masked", _run(calls, 3.0)) == pytest.approx(15.0)


def test_cd_sweeps_is_the_window_sweeps_over_its_columns():
    calls = [[_iteration("f", 1.0, b1=(300, 100)),
              _iteration("f", 2.0, b1=(100, 100), b2=(600, 50))],
             [_iteration("g", 2.5, b2=(60, 50)),
              _iteration("g", 3.5, b2=(1000, 1))]]
    assert _read("cd_sweeps.fit", _run(calls, 3.0)) == \
        pytest.approx(1060 / 300)


def _kernels(*calls):
    k = devtrace.KernelCalls()
    k.calls = list(calls)
    return k


def _call(label, *tensors):
    return devtrace.KernelCall(label, [devtrace._meta(t) if t is not None
                                       else (np.arange(3), np.arange(3))
                                       for t in tensors], {}, None, None)


def test_cd_roofline_counts_operations_and_bytes():
    n, k = 1000, 10
    npairs = k * (k + 1) // 2
    a, B = torch.zeros(k, k), torch.zeros(n, k)
    kern = _kernels(
        _call("B1", a, B, B),
        _call("B2", a, torch.zeros(npairs, n), None, B, B),
        _call("B2", torch.zeros(k, k, n), B, B))
    profile = types.SimpleNamespace(seconds=lambda *labels: 1e-6)
    calls = [[dict(event="fit_start", fit="f", k=k, t=0.5),
              _iteration("f", 1.0, b1=(3000, 1000), b2=(800, 200))]]
    ops1 = 2 * k * k * (3000 + 1000)
    ops2 = 2 * k * k * (800 + 200)
    bytes1 = 4 * (k * k + 3 * n * k)
    bytes2 = 4 * (k * k + npairs * n + 3 * n * k) \
        + 4 * (k * k * n + 3 * n * k)
    need = roofline.bound_s(bytes1, ops1, "f32") \
        + roofline.bound_s(bytes2, ops2, "f32")
    run = _run(calls, 2.0, kern, profile)
    assert _read("cd_roofline.iter", run) == pytest.approx(
        100 * need / 1e-6)
    # the iterations of a fit whose start the window lacks count nothing
    calls[0][0]["fit"] = "other"
    assert _read("cd_roofline.iter", _run(calls, 2.0, kern, profile)) is None


@pytest.mark.parametrize("name", READERS)
def test_readers_read_nothing_without_spans_or_counters(name):
    plain = [[dict(event="fit_start", fit="f", k=4, t=0.1),
              dict(event="iteration", fit="f", t=1.0, ms=2.0, iter=1,
                   tol=0.5),
              dict(event="fit_end", fit="f", n_iter=1, t=1.2)]]
    kern = _kernels(_call("B1", torch.zeros(4, 4), torch.zeros(8, 4),
                          torch.zeros(8, 4)))
    profile = types.SimpleNamespace(seconds=lambda *labels: 1.0)
    assert _read(name, _run(plain, 2.0, kern, profile)) is None
    assert _read(name, _run([], 2.0)) is None


def test_cd_roofline_reads_nothing_untraced():
    calls = [[dict(event="fit_start", fit="f", k=4, t=0.1),
              _iteration("f", 1.0, b1=(30, 10))]]
    assert _read("cd_roofline.fit", _run(calls, 2.0)) is None
    assert _read("cd_sweeps.fit", _run(calls, 2.0)) == pytest.approx(3.0)


@pytest.mark.parametrize("driver", ["run_nmf", "cross_validate_nmf"])
def test_readers_on_the_program_with_its_spans_on(driver):
    """The program's own events, logged to the harness's ``Events`` with
    the spans turned on: the host readers read them, and the pack and the
    roofline, which need the card, read nothing on the CPU."""
    from portbench import tap
    from singlet_tpu_torch import tracing
    from singlet_tpu_torch.solvers import drivers

    rng = np.random.default_rng(2)
    A = (rng.random((60, 90)) * (rng.random((60, 90)) < 0.3)).astype(
        np.float32)
    events = tap.Events()
    events.spans = True
    prev = tracing.set_metric_logger(events)
    calls = []
    try:
        for seed in (1, 2):
            n = len(events.events)
            if driver == "run_nmf":
                drivers.run_nmf(A, 3, tol=0.0, maxit=3, seed=seed,
                                device="cpu")
            else:
                drivers.cross_validate_nmf(A, [3], n_replicates=1, tol=0.0,
                                           maxit=3, seed=seed, verbose=0,
                                           device="cpu")
            calls.append(events.events[n:])
    finally:
        tracing.set_metric_logger(prev)
    run = _run(calls, max(e["t"] for c in calls for e in c))
    for name in ("edge_ms.fit", "dispatch_ms.fit"):
        assert _read(name, run) > 0
    assert _read("cd_sweeps.fit", run) >= 1.0
    assert _read("pack_ms.masked", run) is None
    assert _read("cd_roofline.fit", run) is None

"""The harness end to end on the CPU at tiny sizes: the cells come out
correct, a new configuration, operand kind, entry, cell, end-to-end and
per-layer metric are taken up from new files alone, the control and each
fault a cell can have come out not correct (faults are planted under the
harness by patching the step tap and the entries), and the run refuses
JAX and the JAX package by whole name."""

import json
import os
import subprocess
import sys

import pytest
import torch

from conftest import (BENCH_DIR, ROOT, TINY_CONFIGS, TINY_LIMITS, lay_out,
                      write_json)
from portbench import harness, reference, registry, tap

CELLS = ["dtiny.fit", "dtiny.cv", "etiny.fit", "etiny.cv"]


def run(root, cell, seed=101, **kw):
    return harness.run_cell(root, cell, seed, 0.2, False, device="cpu", **kw)


@pytest.mark.parametrize("cell", CELLS)
def test_tiny_cells_are_correct(tiny_bench, cell):
    out = run(tiny_bench, cell)
    assert out["correct"], out["checks"]
    assert out["attempted"] >= 1 and out["failed"] == 0
    names = set(out["metrics"])
    assert names == ({"fit_s", "setup_s"} if cell.endswith(".fit")
                     else {"masked_iter_ms", "setup_s"})
    assert list(out)[-1] == "checks"


def test_bits_route_quantization_is_mirrored(tmp_path, monkeypatch):
    """The ELL engine's bits route (int8 mask products, B5-B9's plain
    versions) forced on the CPU, judged with the quantization mirrored."""
    from singlet_tpu_torch.parallel import sharded_ell

    cfg = dict(TINY_CONFIGS["etiny"], mask_products="int8")
    root = lay_out(tmp_path, {"etiny": cfg})
    monkeypatch.setattr(sharded_ell, "_kernel_device", lambda device: True)
    out = run(root, "etiny.cv")
    assert out["correct"], out["checks"]
    # the same fit judged as if its mask products were exact f32 is not
    write_json(os.path.join(root, "configs", "etiny.json"),
               dict(cfg, name="etiny", mask_products="f32"))
    out = run(root, "etiny.cv")
    assert not out["correct"], out["checks"]


NEW_KIND = """import torch

from portbench import reference


def build(cfg, seed, device):
    from singlet_tpu_torch.sparse.matrix import DenseMatrix

    g, c = int(cfg["genes"]), int(cfg["cells"])
    gen = torch.Generator(device=device).manual_seed(seed)
    A = torch.rand((g, c), generator=gen, device=device) + 0.5
    op = reference.DenseOperand(A, g, c)
    Ap = DenseMatrix(data=A, nonempty=op.cell_nonempty, rows_true=g,
                     cols_true=c, cols_are_cells=True, block=c)
    Atp = DenseMatrix(data=A.T, nonempty=op.gene_nonempty, rows_true=c,
                      cols_true=g, cols_are_cells=False, block=g,
                      mask_cache=Ap.mask_cache)
    return (Ap, Atp), op
"""
NEW_ENTRY = """from portbench.judge import FitRules

MASKED = False


def call(drivers, P, seed, args):
    return drivers.run_nmf(P, rank=args["k"], seed=seed, tol=args["tol"],
                           maxit=args["maxit"])


def rules(seed, args):
    return FitRules(masked=False, k=args["k"], k_top=args["k"],
                    init_seed=seed, tol=args["tol"], L1=0.01,
                    maxit=args["maxit"])


def answers(out):
    return dict(w=out.w, d=out.d, h=out.h)
"""


def _write(path, text):
    with open(path, "w") as f:
        f.write(text)


def test_new_config_cell_and_metric_from_files_alone(tiny_bench):
    bench_path = os.path.join(os.path.dirname(tiny_bench), "BENCHMARK.json")
    with open(bench_path) as f:
        bench = json.load(f)
    write_json(os.path.join(tiny_bench, "configs", "dnew.json"),
               dict(TINY_CONFIGS["dtiny"], name="dnew", genes=72, cells=40))
    write_json(os.path.join(tiny_bench, "workloads", "dnew.cv.json"),
               {"config": "dnew", "entry": "cross_validate_nmf",
                "args": {"ranks": [3], "n_replicates": 1, "maxit": 6,
                         "verbose": 0, "trace_test_mse": 2},
                "warmup_args": {"maxit": 1},
                "check": {"cells": 100, "genes": 100},
                "limits": {"init_gap": 0.0, "fit_gap": 2e-5,
                           "stop_gap": 0.05}})
    _write(os.path.join(tiny_bench, "metrics", "calls_seen.py"),
           'LAYER = "drivers"\nUNIT = "calls"\n\n\n'
           'def read(run):\n    return len(run.calls)\n')
    # a new operand kind, entry and end-to-end metric, and a cell on them
    write_json(os.path.join(tiny_bench, "configs", "onew.json"),
               {"name": "onew", "operand": "dense_shifted", "genes": 60,
                "cells": 48})
    _write(os.path.join(tiny_bench, "operands", "dense_shifted.py"),
           NEW_KIND)
    _write(os.path.join(tiny_bench, "entries", "plain_fit.py"), NEW_ENTRY)
    _write(os.path.join(tiny_bench, "end_to_end", "iter_s.py"),
           'BOUNDARY = "iteration"\n\n\n'
           'def value(span_s, count):\n    return span_s / count\n')
    write_json(os.path.join(tiny_bench, "workloads", "onew.fit.json"),
               {"config": "onew", "entry": "plain_fit",
                "args": {"k": 3, "tol": 1e-5, "maxit": 8},
                "warmup_args": {"maxit": 1},
                "check": {"cells": 100, "genes": 100},
                "limits": dict(TINY_LIMITS)})
    bench["workloads"] += [{"name": "dnew.cv", "chips": 1},
                           {"name": "onew.fit", "chips": 1}]
    bench["end_to_end"][1]["workloads"].append("dnew.cv")
    bench["end_to_end"].append({"name": "iter_s", "unit": "s",
                                "workloads": ["onew.fit"]})
    bench["per_layer"].append({"name": "calls_seen.masked",
                               "workloads": ["dnew.cv"]})
    bench["per_layer"][1]["workloads"].append("dnew.cv")
    write_json(bench_path, bench)
    out = harness.run_cell(tiny_bench, "dnew.cv", 5, 0.2, True,
                           device="cpu")
    assert out["correct"], out["checks"]
    assert out["metrics"]["calls_seen.masked"]["value"] >= 1
    assert out["metrics"]["calls_seen.masked"]["unit"] == "calls"
    assert "iters_per_fit.masked" in out["metrics"]
    # a reader with nothing to read (no device trace here) is left out
    assert "idle_share.masked" not in out["metrics"]
    out = harness.run_cell(tiny_bench, "onew.fit", 6, 0.2, False,
                           device="cpu")
    assert out["correct"], out["checks"]
    assert set(out["metrics"]) == {"iter_s", "setup_s"}
    assert out["metrics"]["iter_s"]["unit"] == "s"
    assert 0 < out["metrics"]["iter_s"]["value"] < 0.2


@pytest.mark.parametrize("cell", CELLS)
def test_control_is_not_correct(tiny_bench, cell):
    """The reference at TF32 (and int4 mask products where quantized) in
    the program's place fails a number of the cell."""
    ctl = reference.Precision(dtype=torch.float32, tf32=True, q_max=7,
                              tol_inputs=torch.bfloat16)
    out = run(tiny_bench, cell, control={"tf32": ctl})
    limits = {n: c["limit"] for n, c in out["checks"].items()}
    failed = [n for n, v in out["control"]["tf32"].items()
              if n in limits and v > limits[n]]
    assert failed, (out["control"], limits)


def break_steps(monkeypatch, fault=None, mse_fault=None):
    """Plant ``fault(W, H, out)`` on each step's outputs, and
    ``mse_fault(n, err)`` on the n-th test error of each fit, under the
    step tap."""
    wrap = tap.StepTap._wrap

    def broken_wrap(self, step, mse=None):
        def broken(W, H, cap):
            out = step(W, H, cap)
            return out if fault is None else fault(W, H, out)
        calls = []

        def broken_mse(W, d, H):
            calls.append(1)
            err = mse(W, d, H)
            return err if mse_fault is None else mse_fault(len(calls), err)
        return wrap(self, broken, None if mse is None else broken_mse)
    monkeypatch.setattr(tap.StepTap, "_wrap", broken_wrap)


def _unchanged(W, H, out):
    W1, H1, d, tol = out
    return W, H, torch.ones_like(d), tol


def _half(W, H, out):
    W1, H1, d, tol = out
    H1 = H1.clone()
    H1[::2] = H[::2]
    return W1, H1, d, tol


def _low_tol(W, H, out):
    W1, H1, d, tol = out
    return W1, H1, d, tol * 0.5


@pytest.mark.parametrize("cell", CELLS)
@pytest.mark.parametrize("fault", [_unchanged, _half, _low_tol])
def test_broken_step_is_not_correct(tiny_bench, monkeypatch, cell, fault):
    break_steps(monkeypatch, fault)
    out = run(tiny_bench, cell)
    assert not out["correct"], out["checks"]


@pytest.mark.parametrize("cell, low, caught", [("dtiny.cv", 1, "fit_gap"),
                                              ("etiny.cv", 2, "stop_gap")])
def test_wrong_overfit_stop_is_not_correct(tiny_bench, monkeypatch, cell,
                                           low, caught):
    """The fit's least test error before its last trace reported 1% low.
    On etiny that moves the last trace's overfit score past the threshold
    and the fit stops early (``stop_gap``'s replay); on dtiny the fit
    stops where it would have, and the wrong error in its trace fails
    ``fit_gap``."""
    break_steps(monkeypatch, mse_fault=lambda n, e: e * 0.99 if n == low
                else e)
    out = run(tiny_bench, cell)
    assert not out["correct"], out["checks"]
    assert out["checks"][caught]["value"] > out["checks"][caught]["limit"]
    if caught == "stop_gap":
        assert out["checks"]["stop_gap"]["value"] >= 1.0


def _altered(answers):
    answers = dict(answers)
    if "test_error" in answers:
        answers["test_error"] = answers["test_error"][:-1] + \
            [answers["test_error"][-1] * 1.001]
    else:
        answers["w"] = answers["w"].copy()
        answers["w"][0, 0] += 1e-6
    return answers


@pytest.mark.parametrize("cell", CELLS)
def test_altered_answer_is_not_correct(tiny_bench, monkeypatch, cell):
    with open(os.path.join(tiny_bench, "workloads", f"{cell}.json")) as f:
        name = json.load(f)["entry"]
    entry = registry.plugin(tiny_bench, "entries", name)
    answers = entry.answers
    monkeypatch.setattr(entry, "answers", lambda out: _altered(answers(out)))
    out = run(tiny_bench, cell)
    assert not out["correct"], out["checks"]


def test_forbidden_modules_by_whole_name(monkeypatch):
    assert harness.forbidden_modules() == []
    import types

    monkeypatch.setitem(sys.modules, "singlet_tpu_torch_extra",
                        types.ModuleType("singlet_tpu_torch_extra"))
    monkeypatch.setitem(sys.modules, "jaxfoo", types.ModuleType("jaxfoo"))
    assert harness.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "singlet_tpu.ops",
                        types.ModuleType("singlet_tpu.ops"))
    monkeypatch.setitem(sys.modules, "jax", types.ModuleType("jax"))
    assert harness.forbidden_modules() == ["jax", "singlet_tpu"]


def test_harness_imports_no_jax():
    code = ("import sys; sys.path.insert(0, %r); "
            "from portbench import harness, devtrace, tap; "
            "import portbench.run; "
            "print(harness.forbidden_modules())" % ROOT)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"


def test_run_refuses_without_program_or_card(tmp_path):
    import shutil

    shutil.copytree(BENCH_DIR, tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), tmp_path)
    args = [sys.executable, "portbench/run.py", "--workload",
            "bench16k.fit", "--seed", "1", "--seconds", "1", "--trace", "0"]
    for cwd in (tmp_path, ROOT):
        out = subprocess.run(args, cwd=cwd, capture_output=True, text=True,
                             timeout=300)
        assert out.returncode != 0 and out.stdout.strip() == "", out.stdout

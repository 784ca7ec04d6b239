"""Shared fixtures of the benchmark's own tests.

``tiny_bench`` lays out a benchmark folder with tiny configurations of
both operand kinds and a cell of each driver on each, which the harness
runs on the CPU with the program's plain versions. Tests that need the
card carry the ``cuda`` marker and skip from the ``card`` fixture.

Run: ``python -m pytest portbench/tests -q`` from the root of the repo.
"""

import json
import os
import shutil
import sys

import pytest

BENCH_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH_DIR)
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

TINY_CONFIGS = {
    "dtiny": {"operand": "dense_uniform", "genes": 96, "cells": 64,
              "density": 0.3, "low": 0.1, "high": 3.0, "gene_block": 4096,
              "cell_block": 2048, "mask_products": "f32"},
    "etiny": {"operand": "bell_closed_form", "genes": 1024, "cells": 256,
              "nnz_per_cell": 40, "gene_block": 512, "cell_block": 128,
              "mask_products": "f32"},
}
FIT_ARGS = {"rank": 4, "tol": 1e-5, "maxit": 12, "L1": 0.01}
CV_ARGS = {"ranks": [4], "n_replicates": 1, "tol": 1e-5, "maxit": 12,
           "L1": 0.01, "test_density": 0.05, "tol_overfit": 1e-4,
           "trace_test_mse": 5, "verbose": 0}
# limits of the tiny cells: the program's plain versions read about 1e-6
# (fit_gap) against the float64 reference here, the TF32 control 2e-4 to
# 1e-3; stop_gap (the first step's tol) up to 2e-5, a tol halved 0.5
TINY_LIMITS = {"init_gap": 0.0, "fit_gap": 2e-5, "stop_gap": 0.05,
               "model_gap": 0.0}
# the harness's folders of files found by name, which a tiny benchmark
# folder copies
PLUGINS = ("metrics", "operands", "entries", "end_to_end")


def pytest_configure(config):
    # one thread a process: the tests run several processes at once
    import torch

    torch.set_num_threads(1)
    config.addinivalue_line(
        "markers", "cuda: needs an NVIDIA card (skips without one)")


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("no CUDA card")


def write_json(path, obj):
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path, "w") as f:
        json.dump(obj, f, indent=1)


def lay_out(tmp, configs=TINY_CONFIGS):
    """A benchmark folder ``tmp/pb`` (and ``tmp/BENCHMARK.json``) with the
    tiny configurations, a ``.fit`` and a ``.cv`` cell of each, and the
    repository's metric readers, operand kinds, entries and end-to-end
    metrics. Returns the folder."""
    root = os.path.join(str(tmp), "pb")
    for folder in PLUGINS:
        shutil.copytree(os.path.join(BENCH_DIR, folder),
                        os.path.join(root, folder),
                        ignore=shutil.ignore_patterns("__pycache__"))
    cells = []
    for name, cfg in configs.items():
        write_json(os.path.join(root, "configs", f"{name}.json"),
                   dict(cfg, name=name))
        lim = dict(TINY_LIMITS)
        write_json(os.path.join(root, "workloads", f"{name}.fit.json"),
                   {"config": name, "entry": "run_nmf", "args": FIT_ARGS,
                    "warmup_args": {"maxit": 2},
                    "check": {"cells": 40, "genes": 50}, "limits": lim})
        lim = {k: v for k, v in TINY_LIMITS.items() if k != "model_gap"}
        write_json(os.path.join(root, "workloads", f"{name}.cv.json"),
                   {"config": name, "entry": "cross_validate_nmf",
                    "args": CV_ARGS, "warmup_args": {"maxit": 1},
                    "check": {"cells": 40, "genes": 50}, "limits": lim})
        cells += [f"{name}.fit", f"{name}.cv"]
    fits = [c for c in cells if c.endswith(".fit")]
    cvs = [c for c in cells if c.endswith(".cv")]
    write_json(os.path.join(str(tmp), "BENCHMARK.json"), {
        "workloads": [{"name": c, "chips": 1} for c in cells],
        "end_to_end": [
            {"name": "fit_s", "unit": "s", "workloads": fits},
            {"name": "masked_iter_ms", "unit": "ms", "workloads": cvs},
            {"name": "setup_s", "unit": "s"}],
        "per_layer": [
            {"name": "fit_setup_ms.fit", "workloads": fits},
            {"name": "iters_per_fit.masked", "workloads": cvs},
            {"name": "idle_share.masked", "workloads": cvs}]})
    return root


@pytest.fixture
def tiny_bench(tmp_path):
    return lay_out(tmp_path)

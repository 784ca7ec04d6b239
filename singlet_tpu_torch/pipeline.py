"""End-to-end pipeline + CLI: dataset -> NMF at optimal rank -> annotation.

Equivalent of ``cellxgene_pipeline`` (reference:R/cellxgene_pipeline.R:17-47):
read a dataset, log-normalize, RunNMF (timed), AnnotateNMF, save a compact
model artifact.

Usage:
  python -m singlet_tpu_torch.pipeline INPUT [--k 10 | --k 2:30 | auto]
      [-o OUT] [--device cuda|cpu]
  torchrun --nproc-per-node N -m singlet_tpu_torch.pipeline INPUT ...
      --devices N
  INPUT: .h5ad file, a 10x mtx directory, a Seurat .rds, or 'pbmc3k'

A copy of ``singlet_tpu/pipeline.py`` over the port's ``Experiment``. Its
``n_devices > 1`` (the JAX package's ``make_mesh(n)`` in one process) is
here a world of N ranks, one process a device as ``torchrun`` starts them:
the pipeline joins the world (``parallel.initialize``), raises where its
size differs from ``n_devices``, and every rank reads the input and fits
on its own cells of the ``"cells"`` mesh (``parallel.global_mesh``). Rank 0
alone writes the files, and every rank waits for them at a barrier. The
CLI's ``--device`` (default ``cuda``) is the fits' device.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time
from pathlib import Path


def load_any(path: str):
    from singlet_tpu_torch import data as D

    if path == "pbmc3k":
        return D.load_pbmc3k()
    p = Path(path)
    if p.is_dir():
        return D.read_10x_mtx(str(p))
    if p.suffix == ".h5ad":
        return D.read_h5ad(str(p))
    if p.suffix.lower() in (".rds", ".rdata"):
        # the reference pipeline's native input: a Seurat RDS
        # (reference:R/cellxgene_pipeline.R:19-21)
        return D.read_seurat_rds(str(p))
    raise ValueError(f"unrecognized input {path!r} (expected .h5ad, .rds, "
                     "a 10x directory, or 'pbmc3k')")


def _world_mesh(n_devices, device):
    """The ``"cells"`` mesh of a world of ``n_devices`` ranks (None for
    one), after joining the world (``env://`` under torchrun); a world of
    another size raises."""
    import torch.distributed as dist

    from singlet_tpu_torch.parallel import global_mesh, initialize

    want = int(n_devices or 1)
    if want > 1:
        initialize(device=device)
    world = (dist.get_world_size() if dist.is_initialized()
             else int(os.environ.get("WORLD_SIZE", "1")))
    if world != want:
        raise ValueError(f"--devices {want} in a world of {world} ranks: "
                         "run one process a device (torchrun "
                         f"--nproc-per-node {want}) with --devices {want}")
    return global_mesh(device=device) if want > 1 else None


def cellxgene_pipeline(input_path: str, out: str | None = None,
                       k=None, reps: int = 1, L1: float = 0.05,
                       verbose: int = 2, seed: int = 0,
                       metrics: str | None = None,
                       n_devices: int | None = None,
                       h5ad_out: str | None = None, config=None,
                       device=None, **run_kw):
    """The pipeline: load -> preprocess -> NMF (timed) -> annotate -> save.

    ``metrics`` streams structured per-iteration JSONL events;
    ``n_devices`` > 1 runs the fits on a world of that many ranks (this
    process one of them); ``h5ad_out`` also writes the full experiment
    (matrix + reductions) as AnnData. ``config`` (an
    :class:`~singlet_tpu_torch.config.NMFConfig`) supplies the solver
    hyperparameters; the explicit k/reps/L1/verbose/seed arguments and any
    extra keyword arguments override its fields. ``device`` is the fits'
    (default ``"cuda"``). On a world of ranks rank 0 alone writes.
    """
    import contextlib

    from singlet_tpu_torch.experiment import Experiment
    from singlet_tpu_torch.parallel.collectives import barrier, rank_of
    from singlet_tpu_torch.tracing import metric_logging

    mesh = _world_mesh(n_devices, device)

    print(f"reading {input_path}", flush=True)
    ds = load_any(input_path)
    exp = Experiment.from_dataset(ds)
    if exp.counts is not None:
        print(" normalizing...", flush=True)
        exp.preprocess_data()
    else:
        print(" input already normalized (logcounts); skipping "
              "LogNormalize", flush=True)
    print(" running NMF...", flush=True)
    t0 = time.time()
    ctx = metric_logging(metrics) if metrics else contextlib.nullcontext()
    with ctx:
        exp.run_nmf(k=k, config=config, reps=reps, L1=L1, verbose=verbose,
                    seed=seed, mesh=mesh, device=device, **run_kw)
    runtime = time.time() - t0
    print(f" NMF took {runtime:.1f}s", flush=True)
    print(" annotating NMF model...", flush=True)
    exp.annotate_nmf()
    model = exp.reductions["nmf"]
    model.misc["runtime"] = runtime
    model.misc["dataset"] = str(input_path)

    if out is None:
        out = "".join(c for c in Path(input_path).stem if c.isalnum()) or "model"
    if rank_of(mesh) == 0:
        print(f" saving model to {Path(out).with_suffix('')}.npz/.json",
              flush=True)
        model.save(out)
        # annotation frames as sidecar CSVs
        for col, df in (model.misc.get("annotations") or {}).items():
            df.to_csv(f"{out}.annotations.{col}.csv", index=False)
        summary = {
            "k": model.k,
            "runtime_s": runtime,
            "n_genes": int(model.w.shape[0]),
            "n_cells": int(model.h.shape[1]),
        }
        Path(f"{out}.summary.json").write_text(json.dumps(summary, indent=1))
        if h5ad_out:
            print(f" writing {h5ad_out}", flush=True)
            exp.to_h5ad(h5ad_out)
    barrier(mesh)
    return model


def _parse_k(text):
    if text is None or text == "auto":
        return None
    if ":" in text:
        lo, hi = text.split(":")
        return list(range(int(lo), int(hi) + 1))
    if "," in text:
        return [int(v) for v in text.split(",")]
    return int(text)


def main(argv=None):
    ap = argparse.ArgumentParser(
        prog="singlet_tpu_torch.pipeline",
        description="NMF pipeline on PyTorch and CUDA (load, fit, annotate, "
                    "save)")
    ap.add_argument("input", help=".h5ad file, 10x mtx dir, .rds or 'pbmc3k'")
    ap.add_argument("-o", "--out", default=None, help="output path stem")
    ap.add_argument("--k", default="auto",
                    help="'auto' (rank determination), an int, 'lo:hi' range "
                         "or comma list for cross-validation")
    ap.add_argument("--reps", type=int, default=1)
    ap.add_argument("--L1", type=float, default=0.05)
    ap.add_argument("--tol", type=float, default=1e-5)
    ap.add_argument("--maxit", type=int, default=100)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("-v", "--verbose", type=int, default=2)
    ap.add_argument("--metrics", default=None,
                    help="write per-iteration JSONL metric events here")
    ap.add_argument("--devices", type=int, default=None,
                    help="the world's size: N ranks under torchrun, one a "
                         "device")
    ap.add_argument("--h5ad-out", default=None,
                    help="also write the experiment as AnnData (.h5ad)")
    ap.add_argument("--device", default="cuda",
                    help="the fits' device: cuda (default) or cpu")
    args = ap.parse_args(argv)
    cellxgene_pipeline(args.input, out=args.out, k=_parse_k(args.k),
                       reps=args.reps, L1=args.L1, tol=args.tol,
                       maxit=args.maxit, seed=args.seed,
                       verbose=args.verbose, metrics=args.metrics,
                       n_devices=args.devices, h5ad_out=args.h5ad_out,
                       device=args.device)
    return 0


if __name__ == "__main__":
    sys.exit(main())

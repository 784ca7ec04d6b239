"""Chunked ("sparse list") ingestion: the out-of-core / >2^31-nnz path.

Port of ``singlet_tpu/sparse/chunked.py`` (host-only, copied), pointed at
the port's ``native``. The reference handles matrices too large for one
dgCMatrix as a ``std::vector<Rcpp::SparseMatrix>`` of column chunks with
offset bookkeeping (reference:src/singlet.cpp:384-402,469-503,571-607),
plus an R-level "distributed transpose" that re-blocks the gene axis
chunk-by-chunk (reference:R/ard_nmf.R:57-70, reference:R/run_nmf.R:79-107)
and IVSparse binary staging of a matrix and its transpose on disk
(reference:src/singlet.cpp:843-945).

Here chunks are streamed ONE AT A TIME into the blocked-ELL planes the
engine consumes (``parallel.sharded_ell.shard_ell_from_chunks``): the full
CSC matrix is never materialized, and no transpose is ever built (the
engine is transpose-free). This module provides the chunk sources and disk
staging: the native SVC1 compressed shard format (``native``), one file per
chunk plus a JSON manifest, the JAX package's layout, so a directory staged
by either package is read by the other.

Chunks may be scipy sparse matrices, file paths (``.svc`` / ``.npz`` /
``.mtx``), or callables returning either: callables let truly out-of-core
pipelines load, pack, and free one chunk at a time.
"""

from __future__ import annotations

import json
import os
from typing import Callable, List, Sequence, Union

import scipy.sparse as sp

from singlet_tpu_torch import native

__all__ = ["stage_chunks", "staged_chunk_loaders"]

ChunkSource = Union[sp.spmatrix, str, Callable[[], sp.spmatrix]]


def _load_chunk(c: ChunkSource) -> sp.csc_matrix:
    if callable(c) and not sp.issparse(c):
        c = c()
    if isinstance(c, str):
        if c.endswith(".mtx") or c.endswith(".mtx.gz"):
            if native.available() and c.endswith(".mtx"):
                return native.read_mtx(c)
            import scipy.io

            return sp.csc_matrix(scipy.io.mmread(c))
        return native.svc_read(c)
    return sp.csc_matrix(c)


def read_manifest(directory: str) -> dict:
    """The JSON manifest of a staged chunk directory; raises ValueError if
    the directory was not staged by ``stage_chunks``."""
    with open(os.path.join(directory, "manifest.json")) as f:
        meta = json.load(f)
    if meta.get("format") != "svc1-chunks":
        raise ValueError(f"not a staged chunk directory: {directory}")
    return meta


# ---------------------------------------------------------------------------
# Disk staging (write_IVCSC / save_IVSparse / read_IVSparse analogue)
# ---------------------------------------------------------------------------

def stage_chunks(directory: str, chunks: Sequence[ChunkSource],
                 value_compress: bool = False) -> str:
    """Stage column chunks to compressed SVC1 shards + a JSON manifest.

    Counterpart of ``write_IVCSC``/``save_IVSparse``
    (reference:src/singlet.cpp:843-945): persists the dataset in chunked
    compressed form so later fits stream it without re-ingesting the source.
    ``value_compress`` uses the v2 value-grouped encoding (VCSC analogue):
    each distinct value stored once per column, smaller for redundant
    values like raw or log-normalized counts.
    Unlike the reference, the transpose is NOT staged at all: the
    blocked-ELL engine is transpose-free (w-update right-hand sides
    accumulate over the same cell planes, parallel/sharded_ell.py).
    """
    os.makedirs(directory, exist_ok=True)
    meta = {"format": "svc1-chunks", "version": 1, "chunks": [],
            "genes": None, "cells": 0}
    for i, c in enumerate(chunks):
        M = _load_chunk(c)
        if meta["genes"] is None:
            meta["genes"] = int(M.shape[0])
        name = f"chunk_{i:05d}.svc"
        native.svc_write(os.path.join(directory, name), M,
                         value_compress=value_compress)
        meta["chunks"].append({"file": name, "cols": int(M.shape[1]),
                               "nnz": int(M.nnz)})
        meta["cells"] += int(M.shape[1])
        del M
    with open(os.path.join(directory, "manifest.json"), "w") as f:
        json.dump(meta, f, indent=1)
    return directory


def staged_chunk_loaders(directory: str) -> List[Callable[[], sp.csc_matrix]]:
    """Lazy per-chunk loaders for a staged directory (feed to the
    drivers' list input or ``shard_ell_from_chunks``)."""
    meta = read_manifest(directory)

    def loader(name):
        path = os.path.join(directory, name)
        return lambda: native.svc_read(path)

    return [loader(c["file"]) for c in meta["chunks"]]

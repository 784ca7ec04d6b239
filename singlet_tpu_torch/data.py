"""Bundled datasets and ingest helpers.

``load_pbmc3k`` reads the reference's bundled benchmark dataset directly from
its RData container (reference:data/pbmc3k.RData; loader semantics per
reference:R/get_pbmc3k_data.R:14-20: dgCMatrix slots i/p/Dim/Dimnames with an
rle-compressed x, plus a cell_type metadata vector). Also 10x matrix-market
ingest for external data.

A copy of ``singlet_tpu/data.py`` (numpy and scipy; ``h5py`` imported inside
the h5ad functions, as there), with its imports pointed at the port. One
difference: ``load_pbmc3k``'s default path is relative,
``reference/data/pbmc3k.RData`` under the working directory (the reference
package's checkout), where the JAX package names one absolute location.
"""

from __future__ import annotations

import gzip
import os
from dataclasses import dataclass
from typing import List, Optional

import numpy as np
import scipy.sparse as sp

_PBMC3K_PATH = os.path.join("reference", "data", "pbmc3k.RData")


@dataclass
class CellDataset:
    """genes x cells counts with names and per-cell metadata."""

    counts: sp.csc_matrix            # genes x cells
    gene_names: List[str]
    cell_names: List[str]
    meta: dict
    # True when 'counts' actually holds an already-normalized assay (an SCE
    # that only carries logcounts) — consumers must skip LogNormalize then,
    # matching the reference's SCE method (reference:R/RunNMF.R:222-324)
    normalized: bool = False

    @property
    def n_genes(self) -> int:
        return self.counts.shape[0]

    @property
    def n_cells(self) -> int:
        return self.counts.shape[1]


def inverse_rle(lengths: np.ndarray, values: np.ndarray) -> np.ndarray:
    """R's inverse.rle: expand run-length encoding."""
    return np.repeat(np.asarray(values), np.asarray(lengths))


def load_pbmc3k(path: Optional[str] = None) -> CellDataset:
    """Load the 2,700-PBMC benchmark dataset from the reference's RData."""
    from singlet_tpu_torch.sparse.rdata import r_to_python, read_rdata

    path = path or _PBMC3K_PATH
    ws = read_rdata(path)
    p = r_to_python(ws["pbmc3k"])
    x = inverse_rle(p["x"]["lengths"], p["x"]["values"]).astype(np.float32)
    dim = tuple(int(v) for v in p["Dim"])
    mat = sp.csc_matrix(
        (x, p["i"].astype(np.int32), p["p"].astype(np.int64)), shape=dim)
    gene_names, cell_names = [list(n) for n in p["Dimnames"]]
    return CellDataset(
        counts=mat,
        gene_names=gene_names,
        cell_names=cell_names,
        meta={"cell_type": np.asarray(p["cell_type"])},
    )


def read_10x_mtx(directory: str) -> CellDataset:
    """Read a 10x Genomics matrix-market directory (matrix.mtx[.gz],
    features/genes.tsv[.gz], barcodes.tsv[.gz])."""
    import scipy.io

    def _find(*names):
        for n in names:
            for suffix in ("", ".gz"):
                p = os.path.join(directory, n + suffix)
                if os.path.exists(p):
                    return p
        raise FileNotFoundError(f"none of {names} in {directory}")

    def _read_tsv_col(path, col=0):
        op = gzip.open if path.endswith(".gz") else open
        with op(path, "rt") as f:
            return [line.rstrip("\n").split("\t")[col] for line in f]

    mat = scipy.io.mmread(_find("matrix.mtx")).tocsc().astype(np.float32)
    genes = _read_tsv_col(_find("features.tsv", "genes.tsv"), col=1)
    if len(genes) != mat.shape[0]:
        genes = _read_tsv_col(_find("features.tsv", "genes.tsv"), col=0)
    cells = _read_tsv_col(_find("barcodes.tsv"))
    return CellDataset(counts=mat, gene_names=genes, cell_names=cells, meta={})


def read_seurat_rds(path: str) -> CellDataset:
    """Read a Seurat or SingleCellExperiment object (or bare dgCMatrix)
    from an .rds file.

    The input surface of the reference's ``cellxgene_pipeline``
    (reference:R/cellxgene_pipeline.R:19-21: readRDS -> RNA assay counts)
    plus its other ecosystem class (``RunNMF.SingleCellExperiment``,
    reference:R/RunNMF.R:222-324). Parsed by the from-scratch R
    serialization reader (sparse/rdata.py): Seurat S4 -> active assay
    counts + meta.data; SCE S4 -> assays listData counts + colData.
    """
    from singlet_tpu_torch.sparse.rdata import (dgcmatrix_to_csc, r_class,
                                          read_rds, sce_to_parts,
                                          seurat_to_parts)

    obj = read_rds(path)
    cls = r_class(obj)
    normalized = False
    if "Seurat" in cls:
        M, genes, cells, meta = seurat_to_parts(obj)
    elif any(c in cls for c in ("SingleCellExperiment",
                                "SummarizedExperiment",
                                "RangedSummarizedExperiment")):
        M, genes, cells, meta, assay = sce_to_parts(obj)
        if assay == "logcounts":
            import warnings

            warnings.warn(
                f"{path}: SCE has no 'counts' assay; using 'logcounts' — "
                "the data is already normalized and LogNormalize will be "
                "skipped (reference SCE method semantics)")
            normalized = True
    elif "dgCMatrix" in cls:
        M, genes, cells = dgcmatrix_to_csc(obj)
        meta = {}
    else:
        raise ValueError(
            f".rds object of class {cls or ['?']} is not a Seurat object, "
            "SingleCellExperiment, or dgCMatrix")
    return CellDataset(
        counts=sp.csc_matrix(M.astype(np.float32)),
        gene_names=genes if genes is not None
        else [f"gene{i}" for i in range(M.shape[0])],
        cell_names=cells if cells is not None
        else [f"cell{i}" for i in range(M.shape[1])],
        meta=meta,
        normalized=normalized,
    )


def read_h5ad(path: str) -> CellDataset:
    """Read an AnnData .h5ad file (via h5py; anndata not required).

    AnnData stores X as cells x genes; we return genes x cells.
    """
    import h5py

    with h5py.File(path, "r") as f:
        X = f["X"]
        if isinstance(X, h5py.Group):  # sparse
            enc = X.attrs.get("encoding-type", "csr_matrix")
            data = X["data"][:]
            indices = X["indices"][:]
            indptr = X["indptr"][:]
            shape = tuple(X.attrs["shape"])
            if "csr" in str(enc):
                m = sp.csr_matrix((data, indices, indptr), shape=shape)
            else:
                m = sp.csc_matrix((data, indices, indptr), shape=shape)
        else:
            m = sp.csr_matrix(X[:])
        mat = m.T.tocsc().astype(np.float32)

        def _names(group, fallback_n):
            try:
                g = f[group]
                idx_col = g.attrs.get("_index", "_index")
                col = g[idx_col][:]
                return [v.decode() if isinstance(v, bytes) else str(v)
                        for v in col]
            except Exception:
                return [str(i) for i in range(fallback_n)]

        cells = _names("obs", mat.shape[1])
        genes = _names("var", mat.shape[0])
        meta = {}
        try:
            obs = f["obs"]
            for key in obs:
                if key.startswith("_"):
                    continue
                item = obs[key]
                if isinstance(item, h5py.Group) and "codes" in item:
                    cats = [v.decode() if isinstance(v, bytes) else str(v)
                            for v in item["categories"][:]]
                    codes = item["codes"][:]
                    meta[key] = np.array(
                        [cats[c] if c >= 0 else None for c in codes])
        except Exception:
            pass
    return CellDataset(counts=mat, gene_names=genes, cell_names=cells,
                       meta=meta)


def write_h5ad(path: str, dataset: CellDataset,
               reductions: Optional[dict] = None) -> None:
    """Write an AnnData-compatible .h5ad (via h5py; anndata not required).

    The reference hands results to Seurat/SCE objects in-process
    (reference:R/RunNMF.R:155-163); the Python-ecosystem equivalent is an
    AnnData file: X as CSR (cells x genes), obs metadata (categoricals),
    and each NMFModel reduction stored the scanpy way — embeddings in
    ``obsm/X_<name>``, loadings in ``varm/<name>_loadings``, d and factor
    names in ``uns/<name>``. Round-trips through ``read_h5ad`` and loads in
    scanpy/anndata unchanged.
    """
    import h5py

    def _str_ds(group, name, values):
        ds = group.create_dataset(
            name, data=np.asarray([str(v) for v in values], dtype=object),
            dtype=h5py.string_dtype())
        ds.attrs["encoding-type"] = "string-array"
        ds.attrs["encoding-version"] = "0.2.0"
        return ds

    csr = dataset.counts.T.tocsr()          # AnnData is cells x genes
    n_cells, n_genes = csr.shape
    with h5py.File(path, "w") as f:
        f.attrs["encoding-type"] = "anndata"
        f.attrs["encoding-version"] = "0.1.0"
        X = f.create_group("X")
        X.attrs["encoding-type"] = "csr_matrix"
        X.attrs["encoding-version"] = "0.1.0"
        X.attrs["shape"] = np.asarray([n_cells, n_genes], np.int64)
        X.create_dataset("data", data=csr.data.astype(np.float32))
        X.create_dataset("indices", data=csr.indices.astype(np.int32))
        X.create_dataset("indptr", data=csr.indptr.astype(np.int64))

        for gname, names, n in (("obs", dataset.cell_names, n_cells),
                                ("var", dataset.gene_names, n_genes)):
            g = f.create_group(gname)
            g.attrs["encoding-type"] = "dataframe"
            g.attrs["encoding-version"] = "0.2.0"
            g.attrs["_index"] = "_index"
            g.attrs.create("column-order", data=[],
                           dtype=h5py.string_dtype())
            _str_ds(g, "_index",
                    names if names is not None else range(n))

        cols = []
        for key, vals in (dataset.meta or {}).items():
            vals = np.asarray(vals)
            cats, codes = np.unique(vals.astype(str), return_inverse=True)
            g = f["obs"].create_group(key)
            g.attrs["encoding-type"] = "categorical"
            g.attrs["encoding-version"] = "0.2.0"
            g.attrs["ordered"] = False
            _str_ds(g, "categories", cats)
            g.create_dataset("codes", data=codes.astype(np.int32))
            cols.append(key)
        f["obs"].attrs.create("column-order", data=cols,
                              dtype=h5py.string_dtype())

        obsm = f.create_group("obsm")
        varm = f.create_group("varm")
        uns = f.create_group("uns")
        for grp in (obsm, varm, uns):
            grp.attrs["encoding-type"] = "dict"
            grp.attrs["encoding-version"] = "0.1.0"
        for name, model in (reductions or {}).items():
            emb = obsm.create_dataset(
                f"X_{name}", data=np.asarray(model.embeddings, np.float32))
            load = varm.create_dataset(
                f"{name}_loadings",
                data=np.asarray(model.loadings, np.float32))
            for ds in (emb, load):
                ds.attrs["encoding-type"] = "array"
                ds.attrs["encoding-version"] = "0.2.0"
            u = uns.create_group(name)
            u.attrs["encoding-type"] = "dict"
            u.attrs["encoding-version"] = "0.1.0"
            d = u.create_dataset("d", data=np.asarray(model.d, np.float32))
            d.attrs["encoding-type"] = "array"
            d.attrs["encoding-version"] = "0.2.0"
            _str_ds(u, "factor_names", model.factor_names)

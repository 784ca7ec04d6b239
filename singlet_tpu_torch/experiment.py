"""The ecosystem object API: dataset + reductions + graphs in one workflow.

The reference's L4 layer — the S3 methods dispatched
on Seurat / SingleCellExperiment objects (``RunNMF`` reference:R/RunNMF.R,
``RunLNMF`` reference:R/RunLNMF.R:98-190, ``ProjectData``
reference:R/ProjectData.R, ``PreprocessData``, ``FindLocalNeighbors``
reference:R/FindLocalNeighbors.R, ``AnnotateNMF``, ``RunGSEA``). Instead of
monkey-patching third-party classes, a single :class:`Experiment` carries the
counts, metadata, fitted reductions and graphs, with methods mirroring the
reference's argument names and dispatch rules.

A copy of ``singlet_tpu/experiment.py`` over the port's drivers, linked
NMF, projection, GCNMF and spatial graphs. Each method that fits or builds
a graph takes ``device=`` beside ``mesh=`` (a ``"cells"`` DeviceMesh,
``parallel.make_mesh``) and passes both on; the default device is the card
(``"cuda"``), and ``device="cpu"`` runs the plain PyTorch path.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, Optional, Sequence

import numpy as np
import scipy.sparse as sp

from singlet_tpu_torch.config import NMFConfig
from singlet_tpu_torch.data import CellDataset
from singlet_tpu_torch.model import NMFModel
from singlet_tpu_torch.preprocess import log_normalize, looks_like_counts, weight_by_split
from singlet_tpu_torch.solvers import drivers
from singlet_tpu_torch.solvers.linked import build_link_matrix, run_linked_nmf
from singlet_tpu_torch.solvers.project import project_model

# distinguishes "k not passed" (config supplies it) from an explicit k=None
# (automatic rank determination)
_UNSET = object()


@dataclass
class Experiment:
    """counts/data (genes x cells), per-cell metadata, reductions, graphs."""

    counts: Optional[sp.spmatrix] = None
    data: Optional[sp.spmatrix] = None          # normalized
    gene_names: Optional[list] = None
    cell_names: Optional[list] = None
    meta: Dict[str, np.ndarray] = field(default_factory=dict)
    reductions: Dict[str, NMFModel] = field(default_factory=dict)
    graphs: Dict[str, sp.spmatrix] = field(default_factory=dict)
    var_features: Optional[list] = None   # FindVariableFeatures output
    # set when .data was ingested from an explicitly-normalized source (SCE
    # logcounts): _assay() then trusts it instead of the integer-sum
    # heuristic, which misfires on integer-valued normalized data
    data_is_normalized: bool = False

    # ------------------------------------------------------------ factory
    @classmethod
    def from_dataset(cls, ds: CellDataset) -> "Experiment":
        # an already-normalized dataset (SCE logcounts) goes straight into
        # the normalized slot — re-running LogNormalize on log-space data
        # would double-transform it
        if getattr(ds, "normalized", False):
            return cls(data=ds.counts, gene_names=list(ds.gene_names),
                       cell_names=list(ds.cell_names), meta=dict(ds.meta),
                       data_is_normalized=True)
        return cls(counts=ds.counts, gene_names=list(ds.gene_names),
                   cell_names=list(ds.cell_names), meta=dict(ds.meta))

    @property
    def n_genes(self) -> int:
        m = self.data if self.data is not None else self.counts
        return m.shape[0]

    @property
    def n_cells(self) -> int:
        m = self.data if self.data is not None else self.counts
        return m.shape[1]

    # ------------------------------------------------------- preprocessing
    def preprocess_data(self, scale_factor: float = 1e4) -> "Experiment":
        """LogNormalize counts into .data (reference:R/PreprocessData.R)."""
        src = self.counts if self.counts is not None else self.data
        self.data = log_normalize(src, scale_factor)
        return self

    def _assay(self):
        """Normalized data, auto-preprocessing raw counts exactly like
        RunNMF.Seurat's integer-sum test (reference:R/RunNMF.R:66-69)."""
        if self.data is None or (not self.data_is_normalized
                                 and looks_like_counts(self.data)):
            self.preprocess_data()
        return self.data

    def find_variable_features(self, n_features: int = 2000,
                               loess_span: float = 0.3) -> "Experiment":
        """vst variable-gene selection (Seurat FindVariableFeatures
        default): populates ``self.var_features`` with the top gene names
        by clipped standardized variance — the slot the reference indexes
        when ``features='var.features'`` (reference:R/RunNMF.R:73-74)."""
        from singlet_tpu_torch.preprocess import variable_features_vst

        src = self.counts if self.counts is not None else self.data
        idx = variable_features_vst(src, n_features=n_features,
                                    loess_span=loess_span)
        names = (self.gene_names if self.gene_names is not None
                 else list(range(self.n_genes)))
        self.var_features = [names[i] for i in idx]
        return self

    # ---------------------------------------------------------- interop
    def to_h5ad(self, path: str, layer: str = "counts") -> "Experiment":
        """Write the experiment (matrix, metadata, reductions) to an
        AnnData-compatible .h5ad — the Python-ecosystem handoff equivalent
        of the reference storing results in Seurat/SCE objects."""
        from singlet_tpu_torch.data import CellDataset, write_h5ad

        mat = self.counts if layer == "counts" and self.counts is not None \
            else self.data
        ds = CellDataset(counts=sp.csc_matrix(mat),
                         gene_names=self.gene_names,
                         cell_names=self.cell_names, meta=self.meta)
        write_h5ad(path, ds, reductions=self.reductions)
        return self

    @classmethod
    def from_h5ad(cls, path: str) -> "Experiment":
        from singlet_tpu_torch.data import read_h5ad

        return cls.from_dataset(read_h5ad(path))

    # --------------------------------------------------------------- NMF
    def run_nmf(self, k=_UNSET, split_by: Optional[str] = None,
                features: Optional[Sequence] = None,
                reduction_name: str = "nmf", reduction_key: str = "NMF_",
                mesh=None, config: Optional[NMFConfig] = None, device=None,
                **overrides) -> "Experiment":
        """RunNMF dispatch (reference:R/RunNMF.R:101-151): k=None -> automatic
        rank determination; k a sequence -> cross-validation then final fit;
        scalar k -> fixed-rank fit. Stores an NMFModel reduction. ``mesh``
        (a ``"cells"`` DeviceMesh) runs every fit split over its ranks, and
        ``device`` is every fit's device.

        Solver hyperparameters (tol, reps, L1, L2, maxit, test_set_density,
        learning_rate, tol_overfit, trace_test_mse, verbose, seed, ...) come
        from ``config`` (an :class:`NMFConfig`, defaults =
        reference:R/RunNMF.R:42-60) and may be overridden per-call as
        keyword arguments (unknown names raise)."""
        cfg = config if config is not None else NMFConfig()
        if k is not _UNSET:
            cfg = cfg.replace(k=k)
        if overrides:
            cfg = cfg.replace(**overrides)
        k = cfg.k
        reps, tol, L1, L2, maxit = cfg.reps, cfg.tol, cfg.L1, cfg.L2, cfg.maxit
        verbose, seed = cfg.verbose, cfg.seed
        test_set_density = cfg.test_set_density
        learning_rate, tol_overfit = cfg.learning_rate, cfg.tol_overfit
        trace_test_mse = cfg.trace_test_mse
        warn = cfg.validate_density()
        if warn:
            import warnings

            warnings.warn(warn)
        A = self._assay()
        gene_names = self.gene_names
        if features is not None:
            if isinstance(features, str) and features == "var.features":
                # reference:R/RunNMF.R:73-74 indexes the Seurat var.features
                # slot; auto-compute vst variable genes when absent (the
                # default Seurat workflow runs FindVariableFeatures first)
                if getattr(self, "var_features", None) is None:
                    self.find_variable_features()
                features = self.var_features
            idx = self._feature_indices(features)
            A = A[idx, :]
            gene_names = [self.gene_names[i] for i in idx] if self.gene_names else None
        if split_by is not None:
            codes = self._split_codes(split_by)
            A = weight_by_split(A, codes)

        cv_data = None
        if k is not None and np.ndim(k) > 0 and len(np.atleast_1d(k)) > 1:
            cv_data = drivers.cross_validate_nmf(
                A, ranks=list(np.atleast_1d(k)), n_replicates=reps,
                tol=cfg.cv_tol_effective, maxit=maxit, verbose=verbose,
                L1=L1, L2=L2, test_density=test_set_density,
                tol_overfit=tol_overfit, trace_test_mse=trace_test_mse,
                seed=seed, mesh=mesh, device=device)
            best = drivers.get_best_rank(cv_data, tol_overfit)
            if verbose:
                print(f"best rank: {best}")
            model = drivers.run_nmf(A, best, tol=tol, maxit=maxit,
                                    verbose=verbose, L1=L1, L2=L2, seed=seed,
                                    mesh=mesh, device=device)
        elif k is None:
            model = drivers.ard_nmf(
                A, k_init=None, k_max=10000, k_min=cfg.k_min,
                n_replicates=reps, tol=tol, cv_tol=cfg.cv_tol_effective,
                maxit=maxit, verbose=verbose,
                L1=L1, L2=L2, test_density=test_set_density,
                learning_rate=learning_rate, tol_overfit=tol_overfit,
                trace_test_mse=trace_test_mse, seed=seed, mesh=mesh,
                device=device)
            cv_data = model.cv_data
        else:
            model = drivers.run_nmf(A, int(np.atleast_1d(k)[0]), tol=tol,
                                    maxit=maxit, verbose=verbose, L1=L1,
                                    L2=L2, seed=seed, mesh=mesh,
                                    device=device)
        model.gene_names = gene_names
        model.cell_names = self.cell_names
        model.reduction_key = reduction_key
        model.cv_data = cv_data if cv_data is not None else model.cv_data
        self.reductions[reduction_name] = model
        return self

    # -------------------------------------------------------------- LNMF
    def run_lnmf(self, split_by: str, reduction_use: str = "nmf",
                 reduction_name: str = "lnmf", reduction_key: str = "LNMF_",
                 link_cutoff: float = 0.5, tol: float = 1e-5,
                 maxit: int = 100, L1: float = 0.01, L2: float = 0.0,
                 verbose: bool = True, mesh=None,
                 device=None) -> "Experiment":
        """Linked NMF initialized from an existing reduction
        (reference:R/RunLNMF.R:98-190). ``mesh`` runs the linked fit
        split over its ranks on the sparse engine."""
        if reduction_use not in self.reductions:
            raise ValueError(f"no reduction {reduction_use!r}; run run_nmf first")
        base = self.reductions[reduction_use]
        A = self._assay()
        codes = self._split_codes(split_by)
        A = weight_by_split(A, codes)
        link_h, unlink, levels = build_link_matrix(base.embeddings, codes,
                                                   link_cutoff)
        model = run_linked_nmf(A, base.w, link_h=link_h, tol=tol, maxit=maxit,
                               verbose=verbose, L1=L1, L2=L2,
                               gene_names=base.gene_names,
                               cell_names=self.cell_names, mesh=mesh,
                               device=device)
        model.reduction_key = reduction_key
        self.reductions[reduction_name] = model
        return self

    # -------------------------------------------------------------- GCNMF
    def run_gcnmf(self, graph, k: int, tol: float = 1e-4, maxit: int = 100,
                  L1: float = 0.01, L2: float = 0.0, seed: int = 0,
                  w_init=None, verbose: bool = False,
                  reduction_name: str = "gcnmf",
                  reduction_key: str = "GCNMF_", mesh=None,
                  device=None) -> "Experiment":
        """Graph-convolutional NMF over a (cells x cells) graph
        (reference:R/RunGCNMF.R:77 over c_gcnmf, src/singlet.cpp:1713-1730).

        ``graph`` is either the name of a graph stored by
        :meth:`find_local_neighbors` or a (cells x cells) matrix. Note the
        reference wrapper has a bug — it passes its Seurat object ``G``
        where the user's ``graph`` argument was meant
        (reference:R/RunGCNMF.R:77); this method implements the documented
        intent."""
        from singlet_tpu_torch.solvers.gcnmf import gcnmf

        G = self.graphs[graph] if isinstance(graph, str) else graph
        A = self._assay()
        if G.shape != (A.shape[1], A.shape[1]):
            raise ValueError(
                f"graph must be cells x cells ({A.shape[1]}), got {G.shape}")
        model = gcnmf(A, G, int(k), tol=tol, maxit=maxit, L1=L1, L2=L2,
                      seed=seed, w_init=w_init, verbose=verbose,
                      gene_names=self.gene_names, cell_names=self.cell_names,
                      mesh=mesh, device=device)
        model.reduction_key = reduction_key
        self.reductions[reduction_name] = model
        return self

    # --------------------------------------------------------- projection
    def project_data(self, w, gene_names_w: Optional[Sequence[str]] = None,
                     split_by: Optional[str] = None, L1: float = 0.01,
                     L2: float = 0.0, reduction_name: str = "nmf_projection",
                     reduction_key: str = "NNLS_",
                     reorder: bool = False, mesh=None,
                     device=None) -> "Experiment":
        """NNLS projection onto an external factor model
        (reference:R/ProjectData.R:37-110): genes are intersected by name.
        ``mesh`` runs the projection split over its ranks on the sparse
        engine (the million-cell ProjectData configuration)."""
        A = self._assay()
        if isinstance(w, NMFModel):
            gene_names_w = w.gene_names
            w = w.w
        w = np.asarray(w)
        if split_by is not None:
            A = weight_by_split(A, self._split_codes(split_by))
        if gene_names_w is not None and self.gene_names is not None:
            ours = {g: i for i, g in enumerate(self.gene_names)}
            keep = [(ours[g], i) for i, g in enumerate(gene_names_w)
                    if g in ours]
            a_rows = [t[0] for t in keep]
            w_rows = [t[1] for t in keep]
            A = A[a_rows, :]
            w = w[w_rows, :]
            used_genes = [self.gene_names[i] for i in a_rows]
        else:
            used_genes = self.gene_names
        h, d = project_model(A, w, L1=L1, L2=L2, mesh=mesh, device=device)
        model = NMFModel(w=w, d=d, h=h, gene_names=used_genes,
                         cell_names=self.cell_names,
                         reduction_key=reduction_key)
        if reorder:
            model = model.sorted_by_d()
        self.reductions[reduction_name] = model
        return self

    # ------------------------------------------------------------- graphs
    def find_local_neighbors(self, coord_cols=("x", "y"),
                             reduction: str = "nmf", k: int = 10,
                             radius: float = 2.0, metric: str = "jaccard",
                             similarity: bool = True, max_dist: float = 0.0,
                             snn: Optional[float] = None,
                             graph_name: str = "lknn",
                             device=None) -> "Experiment":
        """Local spatial kNN (+ optional SNN) graphs
        (reference:R/FindLocalNeighbors.R:95-98), built on ``device``."""
        from singlet_tpu_torch.graphs.spatial import local_knn, snn_graph

        cx = np.asarray(self.meta[coord_cols[0]], np.float32)
        cy = np.asarray(self.meta[coord_cols[1]], np.float32)
        model = self.reductions[reduction]
        G = local_knn(model.h, cx, cy, k=k, radius=radius, metric=metric,
                      similarity=similarity, max_dist=max_dist,
                      device=device)
        self.graphs[graph_name] = G
        if snn is not None:
            self.graphs[graph_name + "_snn"] = snn_graph(G, snn,
                                                         device=device)
        return self

    # --------------------------------------------------------- downstream
    def annotate_nmf(self, columns=None, reduction: str = "nmf", **kw
                     ) -> "Experiment":
        from singlet_tpu_torch.annotate import annotate_nmf

        annotate_nmf(self.reductions[reduction], self.meta, columns=columns,
                     **kw)
        return self

    def run_gsea(self, gene_sets, reduction: str = "nmf", **kw) -> "Experiment":
        from singlet_tpu_torch.gsea import run_gsea

        run_gsea(self.reductions[reduction], gene_sets, **kw)
        return self

    def metadata_summary(self, split_by: str, reduction: str = "nmf",
                         reorder: bool = True):
        from singlet_tpu_torch.summary import metadata_summary

        model = self.reductions[reduction]
        return metadata_summary(model.h, self.meta[split_by], reorder=reorder,
                                factor_names=model.factor_names)

    def shared_factors(self, split_by: str, reduction: str = "lnmf"):
        from singlet_tpu_torch.summary import get_shared_factors

        return get_shared_factors(self.reductions[reduction],
                                  self.meta[split_by])

    def unique_factors(self, split_by: str, reduction: str = "lnmf"):
        from singlet_tpu_torch.summary import get_unique_factors

        return get_unique_factors(self.reductions[reduction],
                                  self.meta[split_by])

    # ------------------------------------------------------------ helpers
    def _split_codes(self, split_by: str) -> np.ndarray:
        vals = np.asarray(self.meta[split_by])
        if any(v is None or v != v for v in vals.tolist()):
            raise ValueError("'split_by' cannot contain NA values")
        _, codes = np.unique(vals.astype(str), return_inverse=True)
        return codes

    def _feature_indices(self, features) -> list:
        if all(isinstance(f, (int, np.integer)) for f in features):
            return list(features)
        index = {g: i for i, g in enumerate(self.gene_names or [])}
        return [index[f] for f in features if f in index]

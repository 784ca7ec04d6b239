"""Spatial graph kernels: radius graphs, local k-NN, shared-nearest-neighbor.

Port of ``singlet_tpu/graphs/spatial.py``, the equivalents of the
reference's graph builders (reference:src/singlet.cpp:1366-1665).
``local_knn`` and ``snn_graph`` run in torch on ``device`` (default
``"cuda"``): distances in (block x n) tiles, inner products as full-f32
matmuls for euclidean/cosine/jaccard and broadcast reductions for
manhattan/hamming/KL, gated by the spatial radius; the neighbour selection
(the k smallest candidates of each point, ties to the lower index, as the
JAX package's stable sort on the host) runs on the device over the
candidate list, and only the selected edges reach the host. The SNN
intersections are blocked 0/1 matmuls. ``rescale_spatial`` and
``spatial_graph`` are numpy, copied. Results are scipy CSC adjacency
matrices (host graph objects).
"""

from __future__ import annotations

import numpy as np
import scipy.sparse as sp
import torch

from singlet_tpu_torch.device import resolve_device


def rescale_spatial(coords: np.ndarray, units: float = 1.0) -> np.ndarray:
    """Convert 0-1 normalized spatial coordinates to integer grid units
    (reference:R/RescaleSpatial.R:10-22): divide by the smallest nonzero
    coordinate spacing and round."""
    coords = np.asarray(coords, np.float64)
    out = np.empty_like(coords)
    for j in range(coords.shape[1]):
        c = coords[:, j]
        diffs = np.diff(np.unique(c))
        step = diffs[diffs > 0].min() if (diffs > 0).any() else 1.0
        out[:, j] = np.round(c / step * units)
    return out


def _pairwise_block(M: torch.Tensor, coords: torch.Tensor, start: int,
                    stop: int, metric: str):
    """Distances from points [start, stop) to all points.

    M: (features, n) column-major profiles; coords: (n, 2), both float32.
    Returns (dist (block, n), spatial_dist (block, n)), float32.
    """
    Mb = M[:, start:stop]                                   # (f, b)
    diff = coords[start:stop, None, :] - coords[None, :, :]
    sdist = torch.sqrt(torch.sum(diff * diff, dim=-1))

    if metric == "euclidean":
        x2 = torch.sum(Mb * Mb, dim=0)[:, None]
        y2 = torch.sum(M * M, dim=0)[None, :]
        xy = Mb.T @ M
        d = torch.sqrt(torch.clamp(x2 + y2 - 2 * xy, min=0.0))
    elif metric in ("cosine", "jaccard"):
        xy = Mb.T @ M
        x2 = torch.sum(Mb * Mb, dim=0)[:, None]
        y2 = torch.sum(M * M, dim=0)[None, :]
        if metric == "cosine":
            d = 1.0 - xy / torch.sqrt(torch.clamp(x2 * y2, min=1e-30))
        else:
            # continuous (Tanimoto) jaccard distance,
            # reference:src/singlet.cpp:1427-1435
            d = 1.0 - xy / torch.clamp(x2 + y2 - xy, min=1e-30)
    elif metric == "manhattan":
        # the reference takes sqrt of the L1 sum
        # (reference:src/singlet.cpp:1446-1451)
        d = torch.sqrt(torch.sum(torch.abs(Mb.T[:, None, :]
                                           - M.T[None, :, :]), dim=-1))
    elif metric == "hamming":
        d = torch.sum(Mb.T[:, None, :] != M.T[None, :, :],
                      dim=-1).to(torch.float32)
    elif metric == "kl":
        # the reference's KL-ish: sum(p) * log(sum(p/q)) over q != 0
        # (reference:src/singlet.cpp:1461-1469)
        q = M.T[None, :, :]
        ratio = torch.where(q != 0, Mb.T[:, None, :] / q, 0.0)
        pdivq = torch.sum(ratio, dim=-1)
        psum = torch.sum(Mb.T, dim=-1)[:, None]
        d = psum * torch.log(torch.clamp(pdivq, min=1e-30))
    else:
        raise ValueError(f"unknown metric {metric!r}")
    return d, sdist


def _row_ranks(rows: torch.Tensor, n_rows: int) -> torch.Tensor:
    """Rank of each entry within its row, for entries grouped by row."""
    counts = torch.bincount(rows, minlength=n_rows)
    starts = torch.cumsum(counts, 0) - counts
    return torch.arange(rows.numel(), device=rows.device) - starts[rows]


def _by_row(rows: torch.Tensor, key: torch.Tensor) -> torch.Tensor:
    """The permutation that groups entries by row, ordered by ``key``
    within a row, ties in their given order (two stable sorts)."""
    order = torch.sort(key, stable=True).indices
    return order[torch.sort(rows[order], stable=True).indices]


def local_knn(M: np.ndarray, coord_x: np.ndarray, coord_y: np.ndarray,
              k: int, radius: float, metric: str = "jaccard",
              similarity: bool = True, max_dist: float = 0.0,
              block: int = 512, verbose: bool = False,
              device=None) -> sp.csc_matrix:
    """Local k-nearest-neighbor graph within a spatial radius
    (reference:src/singlet.cpp:1491-1603, ``c_LKNN``), on ``device``.

    M: (features, n) or (n, features); values = per-point profiles (e.g. h).
    For jaccard/cosine with ``similarity=False`` the reference stores
    1 - distance; that rule is kept. Returns an n x n CSC adjacency whose
    column j holds j's up-to-k selected neighbors (in index order), with
    their float32 distances as float64 values.
    """
    device = resolve_device(device)
    M = np.asarray(M, np.float32)
    n = len(coord_x)
    if M.shape[1] != n:
        if M.shape[0] == n:
            M = M.T
        else:
            raise ValueError("number of columns in 'M' must equal number of "
                             "coordinates")
    coords = np.stack([np.asarray(coord_x, np.float32),
                       np.asarray(coord_y, np.float32)], axis=1)
    Mj = torch.as_tensor(np.ascontiguousarray(M), device=device)
    cj = torch.as_tensor(coords, device=device)
    kk = min(k, n - 1)
    flip = metric in ("jaccard", "cosine") and not similarity

    cols, idx, vals = [], [], []
    for start in range(0, n, block):
        stop = min(start + block, n)
        d, sdist = _pairwise_block(Mj, cj, start, stop, metric)
        d = d.to(torch.float64)
        if flip:
            d = 1.0 - d
        ok = sdist <= radius
        b = torch.arange(stop - start, device=device)
        ok[b, start + b] = False
        if max_dist != 0:
            ok &= d <= max_dist
        # the candidates, nearest first within each point (ties to the
        # lower index), the first kk kept, back in index order
        rows, cand = ok.nonzero(as_tuple=True)
        dist = d[rows, cand]
        perm = _by_row(rows, dist)
        rows, cand, dist = rows[perm], cand[perm], dist[perm]
        keep = _row_ranks(rows, stop - start) < kk
        rows, cand, dist = rows[keep], cand[keep], dist[keep]
        perm = _by_row(rows, cand)
        cols.append((rows[perm] + start).cpu().numpy())
        idx.append(cand[perm].cpu().numpy())
        vals.append(dist[perm].cpu().numpy())

    cols = np.concatenate(cols) if cols else np.zeros(0, np.int64)
    indptr = np.zeros(n + 1, np.int64)
    indptr[1:] = np.cumsum(np.bincount(cols, minlength=n))
    indices = np.concatenate(idx) if idx else np.zeros(0, np.int64)
    data = np.concatenate(vals) if vals else np.zeros(0)
    G = sp.csc_matrix((data, indices, indptr), shape=(n, n))
    G.eliminate_zeros()
    if verbose:
        print(f"selected {G.nnz} edges")
    return G


def snn_graph(G: sp.spmatrix, min_similarity: float = 0.0,
              block: int = 1024, device=None) -> sp.csc_matrix:
    """Shared-nearest-neighbor Jaccard graph (reference:src/singlet.cpp:
    1606-1665, ``c_SNN``) on ``device``: similarity(i,j) = |N(i) ∩ N(j)| /
    |N(i) ∪ N(j)| over the neighbor index sets, 1 on the diagonal for
    non-empty columns, entries kept when > min_similarity.

    Intersections are blocked 0/1 matmuls (exact in float32) instead of
    the reference's serial sorted-pointer walk, the similarities float64.
    """
    device = resolve_device(device)
    n = G.shape[1]
    B = sp.csc_matrix(G)
    pattern = sp.csc_matrix(
        (np.ones_like(B.data), B.indices, B.indptr), shape=B.shape)
    nnz = torch.as_tensor(np.diff(pattern.indptr).astype(np.float64),
                          device=device)
    Pd = torch.as_tensor(np.asarray(pattern.todense(), np.float32),
                         device=device)

    cols, idx, vals = [], [], []
    for start in range(0, n, block):
        stop = min(start + block, n)
        inter = (Pd[:, start:stop].T @ Pd).to(torch.float64)   # (blk, n)
        union = nnz[start:stop, None] + nnz[None, :] - inter
        sim = torch.where(union > 0, inter / union, 0.0)
        sim[:, nnz == 0] = 0.0
        keep = sim > min_similarity
        b = torch.arange(stop - start, device=device)
        # the diagonal 1 of a non-empty column; an empty one stays empty
        keep[b, start + b] = True
        sim[b, start + b] = 1.0
        keep[nnz[start:stop] == 0] = False
        rows, js = keep.nonzero(as_tuple=True)
        cols.append((rows + start).cpu().numpy())
        idx.append(js.cpu().numpy())
        vals.append(sim[rows, js].cpu().numpy())

    cols = np.concatenate(cols) if cols else np.zeros(0, np.int64)
    indptr = np.zeros(n + 1, np.int64)
    indptr[1:] = np.cumsum(np.bincount(cols, minlength=n))
    indices = np.concatenate(idx) if idx else np.zeros(0, np.int64)
    data = np.concatenate(vals) if vals else np.zeros(0)
    return sp.csc_matrix((data, indices, indptr), shape=(n, n))


def spatial_graph(c1: np.ndarray, c2: np.ndarray, max_dist: float,
                  max_k: int = 100, block: int = 1024) -> sp.csc_matrix:
    """Radius-weighted ε-graph (reference:src/singlet.cpp:1366-1414): edge
    weight (max_dist - d)/max_dist for d < max_dist, at most max_k neighbors
    per point taken in index order, columns normalized to sum to 1."""
    coords = np.stack([np.asarray(c1, np.float64),
                       np.asarray(c2, np.float64)], axis=1)
    n = coords.shape[0]
    scale = 1.0 / max_dist
    cols_i, cols_x, indptr = [], [], [0]
    for start in range(0, n, block):
        blk = min(block, n - start)
        diff = coords[start:start + blk, None, :] - coords[None, :, :]
        d = np.sqrt((diff ** 2).sum(-1))
        for bi in range(blk):
            within = np.where(d[bi] < max_dist)[0][:max_k]
            w = (max_dist - d[bi, within]) * scale
            s = w.sum()
            if s > 0:
                w = w / s
            cols_i.append(within)
            cols_x.append(w)
            indptr.append(indptr[-1] + len(within))
    return sp.csc_matrix(
        (np.concatenate(cols_x), np.concatenate(cols_i), np.asarray(indptr)),
        shape=(n, n))

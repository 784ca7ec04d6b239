"""Multiplicative-update NMF (alternative algorithm, parity surface).

Port of ``singlet_tpu/solvers/mu.py``, the equivalent of ``c_mu_nmf_base``
(reference:src/singlet.cpp:1000-1049). The reference's update is a
nonstandard Lee-Seung variant that *divides* by the current factor value
(``h(j,i) = numer(j) / (w_rowsq(j) * h(j,i))``) and never applies the usual
multiplicative ratio; the reference comments flag the solver as
unfinished/experimental. Those semantics are kept verbatim for parity
(``faithful=True``), beside the standard Frobenius multiplicative updates
(``faithful=False``) as the usable variant. Dense products in full f32; no
kernel stands behind either step (the JAX package's are XLA).
"""

from __future__ import annotations

import numpy as np
import torch

from singlet_tpu_torch.device import resolve_device
from singlet_tpu_torch.ops.linalg import cor_distance


def _mu_step_faithful(A, W, H):
    # h(j,i) = (W^T A)(j,i) / (||w_j||^2 * h(j,i))   [reference :1013-1021]
    w_rowsq = torch.sum(W * W, dim=0)                      # (k,)
    numer_h = W.T @ A                                      # (k, cells)
    H = numer_h / (w_rowsq[:, None] * H)
    h_rowsq = torch.sum(H * H, dim=1)
    numer_w = A @ H.T                                      # (genes, k)
    W_new = numer_w / (h_rowsq[None, :] * W)
    return W_new, H


def _mu_step_standard(A, W, H):
    # classic Frobenius MU: H *= (W^T A)/(W^T W H); W *= (A H^T)/(W H H^T)
    WtA = W.T @ A
    WtWH = (W.T @ W) @ H
    H = H * WtA / (WtWH + 1e-12)
    AHt = A @ H.T
    WHHt = W @ (H @ H.T)
    W_new = W * AHt / (WHHt + 1e-12)
    return W_new, H


def _mu_init(genes: int, cells: int, k: int, seed: int, device):
    """W ~ U(0, 1) + 1e-3 (genes, k) and H = |N(0, 1)| + 1e-3 (k, cells),
    from a ``torch.Generator`` seeded with ``seed``. The JAX package draws
    from threefry, so one seed gives other factors than ``singlet_tpu``."""
    gen = torch.Generator(device=device).manual_seed(int(seed))
    W = torch.rand((genes, k), generator=gen, device=device) + 1e-3
    H = torch.randn((k, cells), generator=gen, device=device).abs() + 1e-3
    return W, H


def mu_nmf(A, k: int, tol: float = 1e-4, maxit: int = 100, seed: int = 0,
           verbose: bool = False, faithful: bool = False, device=None):
    """Fit NMF by multiplicative updates on ``device`` (default
    ``"cuda"``). Returns dict(w (genes, k), d (k,) ones, h (k, cells),
    tol_trace)."""
    device = resolve_device(device)
    A = torch.as_tensor(np.asarray(A, np.float32), device=device)
    genes, cells = A.shape
    W, H = _mu_init(genes, cells, k, seed, device)
    step = _mu_step_faithful if faithful else _mu_step_standard
    tol_ = 1.0
    traces = []
    while len(traces) < maxit and tol_ > tol:
        W_prev = W
        W, H = step(A, W, H)
        tol_ = float(cor_distance(W, W_prev))
        traces.append(tol_)
        if verbose:
            print(f"{len(traces):4d} | {tol_:8.2e}")
    d = np.ones(k, np.float32)
    return dict(w=W.cpu().numpy(), d=d, h=H.cpu().numpy(), tol_trace=traces)

"""Batched sequential coordinate-descent NNLS, and its dispatcher.

Port of ``singlet_tpu/ops/nnls.py``: solve ``a x = b`` for ``x >= 0`` by
Gauss-Seidel coordinate descent with residual tracking and clamp-at-zero,
warm-started from the previous ALS iteration's factor values
(reference:src/singlet.cpp:229-250). ``nnls_batch`` is the plain PyTorch
version over all columns at once; ``solve_nnls`` and ``solve_nnls_packed*``
send CUDA calls to the hand-written kernels of ``ops/nnls_cuda.py``: B1 for
a shared Gram, B2 for one Gram per column (the masked fit).

Exact reference semantics per column, as in the JAX package:
  - ``diff = b_i / a_ii - L1 + L2 * x_i``, ``delta = max(diff, -x_i)``,
    full residual downdate ``b -= a[:, i] * delta``;
  - the residual starts at the RAW B (not ``B - a X0``);
  - the sweep-end tol is ``sum_i |dx_i| / (x_i + 1e-15)`` (a clamp from x_i
    contributes x_i / 1e-15, which forces another sweep);
  - a column exits when ``tol / k_div <= 1e-8``, at ``max_sweeps``, or at
    the adaptive ``sweep_cap``.

The sweep-schedule environment variables (``SINGLET_TPU_SWEEPS``,
``SINGLET_TPU_MAX_SWEEPS``, ``SINGLET_TPU_FAST_SWEEPS``,
``SINGLET_TPU_FAST_SWEEPS_MASKED``) keep their names and defaults; they are
read when a fit is built (``SweepSettings.from_env``), not at import.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Optional, Union

import numpy as np
import torch

CD_TOL = 1e-8
# the reference's cap of 100 sweeps per solve (reference:src/singlet.cpp:233)
CD_MAX_SWEEPS = 100
CD_FAST_SWEEPS = 8
CD_FAST_SWEEPS_MASKED = 32
# absolute floor for the exact phase: with tol_target == 0 (maxit-bound
# runs) the relative rule alone would never leave the fast phase
CD_EXACT_TOL = 1e-4

# calls of the plain version (the kernel counts its own launches)
PLAIN_CALLS = 0


@dataclasses.dataclass(frozen=True)
class SweepSettings:
    """The inner-solve sweep schedule: ``mode`` is ``adaptive``,
    ``reference`` or an integer constant cap; ``max_sweeps`` the static cap;
    ``fast`` / ``fast_masked`` the fast-phase caps of plain / masked fits."""

    mode: str = "adaptive"
    max_sweeps: int = CD_MAX_SWEEPS
    fast: int = CD_FAST_SWEEPS
    fast_masked: int = CD_FAST_SWEEPS_MASKED

    @classmethod
    def from_env(cls) -> "SweepSettings":
        env = os.environ
        return cls(
            mode=env.get("SINGLET_TPU_SWEEPS", "adaptive").lower(),
            max_sweeps=int(env.get("SINGLET_TPU_MAX_SWEEPS", CD_MAX_SWEEPS)),
            fast=int(env.get("SINGLET_TPU_FAST_SWEEPS", CD_FAST_SWEEPS)),
            fast_masked=int(env.get("SINGLET_TPU_FAST_SWEEPS_MASKED",
                                    CD_FAST_SWEEPS_MASKED)),
        )


def sweep_cap_update(exact: bool, tol_prev, tol_target, masked: bool = False,
                     settings: Optional[SweepSettings] = None):
    """One step of the adaptive sweep schedule: ``(sweep_cap, exact_next)``.

    ``exact`` is the fit loop's latched exact-phase flag (starts False);
    ``tol_prev`` the previous outer iteration's tol (starts 1.0). The latch
    fires when tol_prev first drops to ``max(10 * tol_target, 1e-4)`` and
    never releases. Compared in float32, as the JAX package does on device.
    The cap is None in ``reference`` mode (no cap below ``max_sweeps``).
    """
    s = settings or SweepSettings.from_env()
    if s.mode == "reference":
        return None, exact
    if s.mode != "adaptive":
        return float(int(s.mode)), exact
    fast = s.fast_masked if masked else s.fast
    thresh = max(np.float32(10.0) * np.float32(tol_target),
                 np.float32(CD_EXACT_TOL))
    exact = bool(exact) or bool(np.float32(tol_prev) <= thresh)
    cap = float(s.max_sweeps) if exact else float(fast)
    return cap, exact


def nnls_batch(
    a: torch.Tensor,
    B: torch.Tensor,
    X0: torch.Tensor,
    L1: Union[float, torch.Tensor] = 0.0,
    L2: float = 0.0,
    update_mask: Optional[torch.Tensor] = None,
    max_sweeps: int = CD_MAX_SWEEPS,
    n_coord=None,
    return_sweeps: bool = False,
    sweep_cap=None,
):
    """Solve n independent NNLS systems a_c x_c = b_c, x_c >= 0, warm-started
    (the plain PyTorch version, on any device).

    a: (k, k) shared Gram or (n, k, k) per-column Grams; B, X0: (n, k) with
    B the RAW product (e.g. A^T W); L1: scalar or (n, k); update_mask: bool
    (n,), False rows come back unchanged; n_coord: overrides k in the exit
    test ``tol / k <= 1e-8``; sweep_cap: caps the sweep count below
    ``max_sweeps``. Returns X (n, k), and per-column sweep counts (n,)
    int32 with ``return_sweeps``.
    """
    global PLAIN_CALLS
    PLAIN_CALLS += 1
    n, k = B.shape
    dtype = B.dtype
    batched_a = a.dim() == 3
    l1_is_array = isinstance(L1, torch.Tensor) and L1.dim() == 2
    if batched_a:
        inv_diag = 1.0 / torch.diagonal(a, dim1=1, dim2=2)    # (n, k)
    else:
        inv_diag = 1.0 / torch.diagonal(a)                    # (k,)

    X = X0.to(dtype).clone()
    Bres = B.clone()
    active = torch.ones(n, dtype=torch.bool, device=B.device)
    if update_mask is not None:
        active &= update_mask.to(torch.bool)
    k_div = torch.tensor(float(k if n_coord is None else n_coord),
                         dtype=torch.float32, device=B.device)
    col_sweeps = torch.zeros(n, dtype=torch.int32, device=B.device)

    sweep = 0
    while bool(active.any()):
        X_prev = X.clone()
        active_f = active.to(dtype)
        for i in range(k):  # sequential Gauss-Seidel recurrence
            if batched_a:
                inv_aii = inv_diag[:, i]
                a_col = a[:, :, i]
            else:
                inv_aii = inv_diag[i]
                a_col = a[:, i][None, :]
            x_i = X[:, i]
            diff = Bres[:, i] * inv_aii
            diff = diff - (L1[:, i] if l1_is_array else L1)
            diff = diff + L2 * x_i
            delta = torch.maximum(diff, -x_i) * active_f
            Bres = Bres - delta[:, None] * a_col
            X[:, i] = x_i + delta
        tol_sweep = torch.sum(torch.abs(X - X_prev) / (X + 1e-15), dim=1)
        sweep += 1
        col_sweeps += active.to(torch.int32)
        active = active & (tol_sweep / k_div > CD_TOL)
        if sweep >= max_sweeps or (sweep_cap is not None
                                   and not float(sweep) < float(sweep_cap)):
            active = torch.zeros_like(active)
    if return_sweeps:
        return X, col_sweeps
    return X


def _check_cuda_problem(B, L1, per_column_grams: bool):
    """On CUDA the kernels take a float32 problem; (n, k) L1 (batch mode)
    only with a shared Gram (B1): with per-column Grams (B2) it raises
    rather than run the plain loop on the card."""
    if per_column_grams and isinstance(L1, torch.Tensor) and L1.dim() == 2:
        raise NotImplementedError(
            "on CUDA kernel B2 (per-column Grams) takes a scalar L1; (n, k) "
            "L1 (batch mode) is ported for a shared Gram only")
    if B.dtype != torch.float32:
        raise NotImplementedError(
            f"on CUDA the CD-NNLS kernels take float32, got {B.dtype}")


def solve_nnls(a, B, X0, L1=0.0, L2=0.0, update_mask=None,
               max_sweeps: int = CD_MAX_SWEEPS, n_coord=None, sweep_cap=None):
    """Dispatcher: the kernels for CUDA tensors, the plain version on the
    CPU.

    On CUDA a shared (k, k) Gram goes to kernel B1, with a scalar or an
    (n, k) L1, and per-column (n, k, k) Grams to kernel B2's tile entry
    (in its (k, k, n) layout, as the JAX dispatcher sends them to
    ``nnls_batch_pallas_batched_a``) with a scalar L1: (n, k) L1 there
    raises rather than run the plain loop. Float32 only.
    """
    if B.device.type == "cuda":
        _check_cuda_problem(B, L1, a.dim() == 3)
        from singlet_tpu_torch.ops import nnls_cuda

        if a.dim() == 3:
            return nnls_cuda.nnls_batch_cuda_batched_at(
                a.permute(2, 1, 0).contiguous(), B, X0, L1=L1, L2=L2,
                update_mask=update_mask, max_sweeps=max_sweeps,
                n_coord=n_coord, sweep_cap=sweep_cap)
        if isinstance(L1, torch.Tensor) and L1.dim() == 2:
            L1 = L1.to(torch.float32).contiguous()
        return nnls_cuda.nnls_batch_cuda(a, B, X0, L1=L1, L2=L2,
                                         update_mask=update_mask,
                                         max_sweeps=max_sweeps,
                                         n_coord=n_coord,
                                         sweep_cap=sweep_cap)
    return nnls_batch(a, B, X0, L1=L1, L2=L2, update_mask=update_mask,
                      max_sweeps=max_sweeps, n_coord=n_coord,
                      sweep_cap=sweep_cap)


def solve_nnls_packed(a_full, packed, iu, B, X0, L1=0.0, L2=0.0,
                      update_mask=None, max_sweeps: int = CD_MAX_SWEEPS,
                      n_coord=None, sweep_cap=None):
    """Per-column NNLS where each column's Gram is ``a_full`` minus a
    packed-triangle correction (the masked-CV formulation,
    reference:src/singlet.cpp:460-464: ``a_i = AAt(w) - AAt(w[:, idx])``).

    ``packed``: (n, npairs) accumulated masked outer products. On CUDA this
    is :func:`solve_nnls_packed_t` on ``packed.T``; on the CPU
    ``nnls_batch(a_full[None] - unpack_sym(packed))``.
    """
    from singlet_tpu_torch.ops.linalg import unpack_sym

    if B.device.type == "cuda":
        return solve_nnls_packed_t(a_full, packed.T, iu, B, X0, L1=L1, L2=L2,
                                   update_mask=update_mask,
                                   max_sweeps=max_sweeps, n_coord=n_coord,
                                   sweep_cap=sweep_cap)
    a = a_full[None] - unpack_sym(packed, B.shape[1], iu)
    return nnls_batch(a, B, X0, L1=L1, L2=L2, update_mask=update_mask,
                      max_sweeps=max_sweeps, n_coord=n_coord,
                      sweep_cap=sweep_cap)


def solve_nnls_packed_t(a_full, packed_t, iu, B, X0, L1=0.0, L2=0.0,
                        update_mask=None, max_sweeps: int = CD_MAX_SWEEPS,
                        n_coord=None, sweep_cap=None):
    """:func:`solve_nnls_packed` with the packed corrections TRANSPOSED,
    ``packed_t`` (npairs, n), the orientation ``linalg.mask_dot_t`` emits.
    On CUDA kernel B2's packed entry reads ``a_full`` and ``packed_t`` in
    place (``nnls_cuda.nnls_batch_cuda_batched_packed_t``); on the CPU the
    (k, k, n) Grams come from one row gather (``unpack_sym_from_t``) and go
    to the plain version with ``a = at.permute(2, 1, 0)``.
    """
    from singlet_tpu_torch.ops.linalg import unpack_sym_from_t

    if B.device.type == "cuda":
        _check_cuda_problem(B, L1, True)
        from singlet_tpu_torch.ops.nnls_cuda import \
            nnls_batch_cuda_batched_packed_t

        return nnls_batch_cuda_batched_packed_t(
            a_full.contiguous(), packed_t.contiguous(), iu, B, X0, L1=L1,
            L2=L2, update_mask=update_mask, max_sweeps=max_sweeps,
            n_coord=n_coord, sweep_cap=sweep_cap)
    at = unpack_sym_from_t(packed_t, B.shape[1], iu, a_full)
    return nnls_batch(at.permute(2, 1, 0), B, X0, L1=L1, L2=L2,
                      update_mask=update_mask, max_sweeps=max_sweeps,
                      n_coord=n_coord, sweep_cap=sweep_cap)

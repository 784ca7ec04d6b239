"""Kernels B1 and B2: batched CD-NNLS, hand-written in CUDA.

B1 (``nnls_batch_cuda``) solves against one shared Gram and replaces
``singlet_tpu/ops/pallas_nnls.py`` ``nnls_batch_pallas`` (body
``_nnls_kernel``), the kernel of both plain ALS half-updates; its source is
``csrc/nnls_cd.cu`` (G lanes a column, 32 / G columns a warp, the Gram
staged transposed in shared memory; ``b1_plan`` picks G). It takes a
scalar L1 or a per-coordinate (n, k) one. B2 solves against one Gram per
column and replaces
``nnls_batch_pallas_batched_at`` (body ``_nnls_kernel_batched``), the
kernel of the masked half-updates; its source is ``csrc/nnls_cd_batched.cu``
(a warp or half-warp per column, its coordinates over the lanes, each
step's delta broadcast by a shuffle; a block stages its eight neighbouring
columns' Grams in shared memory once and sweeps them there). B2 has two entries on
one kernel body: ``nnls_batch_cuda_batched_at`` takes the Grams as the
coordinate tiles ``at`` (k, k, n), the layout of the JAX kernel, and
``nnls_batch_cuda_batched_packed_t`` takes what a masked half-update makes
them from, ``a_full`` (k, k) and the packed corrections ``packed_t``
(npairs, n), and forms each entry on the card with the bits of
``linalg.unpack_sym_from_t``. Each source's header note gives its design
and what bounds it on the card. ``_build.py`` compiles them with nvcc at
first use and this module binds them with ctypes. Both kernels take k <=
512 (``MAX_K``, ``MAX_K_BATCHED``) and raise past it.

On a CUDA tensor each wrapper launches its kernel or raises; on a CPU
tensor it runs the plain version ``ops.nnls.nnls_batch``, because there is
no card to launch on. Importing this module needs neither nvcc nor a card:
the libraries are built and loaded at the first launch.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import numpy as np
import torch

from singlet_tpu_torch.ops import linalg
from singlet_tpu_torch.ops.nnls import CD_MAX_SWEEPS, nnls_batch

# kernel launches (one per call on a CUDA tensor) of B1 and of B2; read by
# chip_smoke.py to show that a fit went through the kernels
LAUNCHES = 0
LAUNCHES_BATCHED = 0

# B1: a column over G lanes, up to 8 coordinates a lane in registers (16
# past k = 224); up to k = 224 the transposed Gram is staged in shared
# memory (at most 200,704 of the 232,448 bytes a Hopper block may use),
# past it the kernel reads it from device memory with G = 32
MAX_K_SHARED = 224
MAX_K = 512
_SMEM_BLOCK = 232448
# the plan's aim: at least this many warps a call (about two a scheduler
# of an H100's 132 multiprocessors), where fewer columns a warp allow it
_B1_MIN_WARPS = 1024
# coordinates a lane on the shared-memory route at an odd pitch (scalar
# loads; 16-byte loads take up to 16)
_B1_MAX_NPL_SHARED = 8
# shared memory of a block's sweep terms and L1 (8 warps of 32 lanes each)
# and 1/diag, per coordinate a lane, float32 (nnls_cd.cu ``term_bytes``)
_B1_TERM_BYTES = 17 * 32 * 4
# B2: a column's coordinates over the 32 lanes of a warp, up to 16 each in
# registers; the same limit as B1, which the final plain fit of a rank
# search runs at the chosen rank
MAX_K_BATCHED = 512

# the C entry points of B2 take six pointers, n, k, L1, L2, k_div, cap,
# max_sweeps and the stream
_ARGTYPES = ([ctypes.c_void_p] * 6
             + [ctypes.c_int, ctypes.c_int, ctypes.c_float, ctypes.c_float,
                ctypes.c_float, ctypes.c_float, ctypes.c_int,
                ctypes.c_void_p])
# B2's packed entry: a_full, packed_t and the row-start table in place of
# the tile and 1/diag, then the arguments above
_ARGTYPES_PACKED = [ctypes.c_void_p] + _ARGTYPES
# B1's entry: a, aT, l1, B, X0, mask, X, then n, k, g, L1, L2, k_div, cap,
# max_sweeps and the stream
ARGTYPES_B1 = ([ctypes.c_void_p] * 7
               + [ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_float,
                  ctypes.c_float, ctypes.c_float, ctypes.c_float,
                  ctypes.c_int, ctypes.c_void_p])
_BOUND: dict = {}


def _kernel(source: str = "nnls_cd", symbol: str = "nnls_cd",
            argtypes=ARGTYPES_B1):
    """(entry point, error-string function) of ``csrc/<source>.cu``,
    building and loading the library once."""
    if symbol not in _BOUND:
        from singlet_tpu_torch import _build

        lib = _build.load(source)
        fn = getattr(lib, symbol)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
        err_str = getattr(lib, f"{source}_error_string")
        err_str.argtypes = [ctypes.c_int]
        err_str.restype = ctypes.c_char_p
        _BOUND[symbol] = (fn, err_str)
    return _BOUND[symbol]


def _kernel_batched():
    return _kernel("nnls_cd_batched", "nnls_cd_batched", _ARGTYPES)


def _check(name, t, shape, dtype, device):
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise TypeError(f"{name} has dtype {t.dtype}, expected {dtype}")
    if tuple(t.shape) != shape:
        raise ValueError(
            f"{name} has shape {tuple(t.shape)}, expected {shape}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


class B1Plan(NamedTuple):
    """B1's split of one call's work (see ``b1_plan``)."""
    g: int         # lanes a column: 2, 4, 8, 16 or 32
    npl: int       # coordinates a lane, ceil(k / g) (device-memory route:
                   # rounded up to even)
    cols: int      # columns a warp, 32 // g
    warps: int     # column sets (warps' worth of columns) of the call
    shared: bool   # Gram staged in shared memory (k <= 224), else read
                   # from device memory
    pitch: int     # floats of a lane's run in a staged Gram row (4 mod 8:
                   # 16-byte loads; odd: scalar loads)
    smem: int      # dynamic shared memory a block, bytes: the staged
                   # Gram, the warps' sweep terms and L1, and 1/diag


@functools.lru_cache(maxsize=256)
def b1_plan(n: int, k: int) -> B1Plan:
    """B1's plan, from the shapes alone: the fewest lanes a column G (a
    power of two, at least 2) whose staged Gram fits in shared memory,
    with up to 16 coordinates a lane where the lane runs take 16-byte
    loads (a pitch of 4 mod 8 floats), else up to 8 at an odd pitch;
    doubled while the call would run fewer than ``_B1_MIN_WARPS`` warps,
    so that the card fills. Past k = 224 G = 32, up to 16 coordinates a
    lane, and the Gram is read from device memory. Lane p of a column
    holds coordinates p, p + G, ...; the staged Gram row i holds column i
    of a, lane p's entries at p * pitch. The plan does not change the
    bits: every step rounds alike and the sweep tolerance is summed in one
    order for every G (the kernel's note)."""
    if not 1 <= k <= MAX_K:
        raise NotImplementedError(f"kernel B1 takes k <= {MAX_K}, got {k}")
    if k > MAX_K_SHARED:
        npl = -(-k // 32)
        npl += npl & 1
        return B1Plan(32, npl, 1, max(n, 0), False, 32 * npl,
                      npl * _B1_TERM_BYTES)

    def staged(g):
        """(npl, pitch, bytes) of G = g on the shared-memory route: 16-byte
        loads where the wider pitch fits, else an odd pitch (npl <= 8),
        else None. The bytes hold the staged Gram, the warps' sweep
        terms and L1, and 1/diag."""
        npl = -(-k // g)
        if 4 <= npl <= 16:
            pitch = b1_vec_pitch(npl)
            smem = (k + 1) * g * pitch * 4 + npl * _B1_TERM_BYTES
            if smem <= _SMEM_BLOCK:
                return npl, pitch, smem
        if npl <= _B1_MAX_NPL_SHARED:
            pitch = npl | 1
            return npl, pitch, (k + 1) * g * pitch * 4 + npl * _B1_TERM_BYTES
        return None

    g = 2
    while staged(g) is None:
        g *= 2
    while g < 32 and -(-n // (32 // g)) < _B1_MIN_WARPS:
        g *= 2
    npl, pitch, smem = staged(g)
    return B1Plan(g, npl, 32 // g, -(-n // (32 // g)), True, pitch, smem)


def b1_vec_pitch(npl: int) -> int:
    """B1's pitch for 16-byte loads (nnls_cd.cu ``vec_pitch``): npl rounded
    up to 4, then to 4 mod 8 floats, so that a quarter-warp's 8 lanes read
    distinct banks."""
    r = -(-npl // 4) * 4
    return r if (r // 4) % 2 == 1 else r + 4


def nnls_batch_cuda(a, B, X0, L1=0.0, L2=0.0, update_mask=None,
                    max_sweeps: int = CD_MAX_SWEEPS, n_coord=None,
                    sweep_cap=None) -> torch.Tensor:
    """``nnls_batch`` for a shared (k, k) float32 Gram, a scalar L2 and a
    scalar or (n, k) float32 L1.

    a: (k, k); B, X0: (n, k); update_mask: bool (n,) or None. Returns X
    (n, k); rows with update_mask False equal X0 bit for bit.
    """
    if B.device.type != "cuda":
        return nnls_batch(a, B, X0, L1=L1, L2=L2, update_mask=update_mask,
                          max_sweeps=max_sweeps, n_coord=n_coord,
                          sweep_cap=sweep_cap)
    global LAUNCHES
    n, k = B.shape
    if k > MAX_K:
        raise NotImplementedError(f"kernel B1 takes k <= {MAX_K}, got {k}")
    _check("a", a, (k, k), torch.float32, B.device)
    l1 = None
    if isinstance(L1, torch.Tensor) and L1.dim() > 0:
        _check("L1", L1, (n, k), torch.float32, B.device)
        l1, L1 = L1, 0.0
    _check_common(B, X0, update_mask, L1, "B1")
    k_div = float(k if n_coord is None else n_coord)
    X = torch.empty_like(B)
    if n == 0:
        return X
    plan = b1_plan(n, k)
    aT = None
    if not plan.shared:
        # column i of a as row i of a transposed copy, rows of 32 npl
        # floats, zero past k, and row k a copy of row 0
        aT = torch.zeros((k + 1, 32 * plan.npl), dtype=torch.float32,
                         device=B.device)
        aT[:k, :k] = a.t()
        aT[k] = aT[0]
    fn, err_str = _kernel()
    mask_ptr = None if update_mask is None else update_mask.data_ptr()
    with torch.cuda.device(B.device):
        stream = torch.cuda.current_stream(B.device).cuda_stream
        err = fn(a.data_ptr(), None if aT is None else aT.data_ptr(),
                 None if l1 is None else l1.data_ptr(), B.data_ptr(),
                 X0.data_ptr(), mask_ptr, X.data_ptr(), n, k, plan.g,
                 float(L1), float(L2), k_div, _cap(max_sweeps, sweep_cap),
                 int(max_sweeps), stream)
    if err != 0:
        raise RuntimeError(
            f"nnls_cd launch failed: {err_str(err).decode()} ({err})")
    LAUNCHES += 1
    return X


def _check_common(B, X0, update_mask, L1, name):
    n, k = B.shape
    dev = B.device
    _check("B", B, (n, k), torch.float32, dev)
    _check("X0", X0, (n, k), torch.float32, dev)
    if update_mask is not None:
        _check("update_mask", update_mask, (n,), torch.bool, dev)
    if isinstance(L1, torch.Tensor) and L1.dim() > 0:
        raise TypeError(f"kernel {name} takes a scalar L1")


def _launch(bound, symbol, grams, B, X0, update_mask, X, L1, L2, k_div, cap,
            max_sweeps):
    """Launch a bound entry of B2 on the current stream of B's device;
    raise if the launch was refused. ``grams``: the tensors passed before
    B, the tile entry's (at, 1/diag) or the packed entry's (a_full,
    packed_t, row starts)."""
    fn, err_str = bound
    n, k = B.shape
    mask_ptr = None if update_mask is None else update_mask.data_ptr()
    with torch.cuda.device(B.device):
        stream = torch.cuda.current_stream(B.device).cuda_stream
        err = fn(*(t.data_ptr() for t in grams), B.data_ptr(), X0.data_ptr(),
                 mask_ptr, X.data_ptr(), n, k, float(L1), float(L2), k_div,
                 cap, int(max_sweeps), stream)
    if err != 0:
        raise RuntimeError(
            f"{symbol} launch failed: {err_str(err).decode()} ({err})")


def _cap(max_sweeps, sweep_cap) -> float:
    """The kernels' cap: the adaptive sweep cap clamped to max_sweeps."""
    if sweep_cap is None:
        return float(max_sweeps)
    return min(float(sweep_cap), float(max_sweeps))


def nnls_batch_cuda_batched_at(at, B, X0, L1=0.0, L2=0.0, update_mask=None,
                               max_sweeps: int = CD_MAX_SWEEPS, n_coord=None,
                               sweep_cap=None) -> torch.Tensor:
    """``nnls_batch`` for per-column float32 Grams in the coordinate-tile
    layout ``at`` (k, k, n), ``at[i, j, c] = a_c[j, i]``, and scalar L1/L2.

    B, X0: (n, k); update_mask: bool (n,) or None. Returns X (n, k); rows
    with update_mask False equal X0 bit for bit. On the CPU this is the
    plain version with ``a = at.permute(2, 1, 0)``.
    """
    if B.device.type != "cuda":
        return nnls_batch(at.permute(2, 1, 0), B, X0, L1=L1, L2=L2,
                          update_mask=update_mask, max_sweeps=max_sweeps,
                          n_coord=n_coord, sweep_cap=sweep_cap)
    global LAUNCHES_BATCHED
    n, k = B.shape
    if k > MAX_K_BATCHED:
        raise NotImplementedError(
            f"kernel B2 takes k <= {MAX_K_BATCHED}, got {k}")
    _check("at", at, (k, k, n), torch.float32, B.device)
    _check_common(B, X0, update_mask, L1, "B2")
    k_div = float(k if n_coord is None else n_coord)
    # 1 / a_c[i, i] as the plain version computes it: row i * (k + 1) of
    # the (k * k, n) view is at[i, i, :]
    inv_diag = 1.0 / at.reshape(k * k, n)[:: k + 1]
    X = torch.empty_like(B)
    if n == 0:
        return X
    _launch(_kernel_batched(), "nnls_cd_batched", (at, inv_diag), B, X0,
            update_mask, X, L1, L2, k_div, _cap(max_sweeps, sweep_cap),
            max_sweeps)
    LAUNCHES_BATCHED += 1
    return X


@functools.lru_cache(maxsize=None)
def _row_starts_np(k: int):
    """(iu, row starts) of the row-major upper triangle ``triu_pairs(k)``."""
    iu = linalg.triu_pairs(k)
    starts = np.diagonal(linalg._sym_pos(k, iu)).astype(np.int32)
    return iu, starts


def packed_row_starts(k: int, iu) -> np.ndarray:
    """The position table B2's packed entry takes: int32 (k,), the packed
    index of pair (r, r). The packed order is the row-major upper triangle
    of ``linalg.triu_pairs``, so row r's pairs are contiguous and
    ``pos(i, j) = starts[min(i, j)] + |i - j|``, the map
    ``linalg._sym_pos`` gives; another order of ``iu`` raises."""
    ref_iu, starts = _row_starts_np(int(k))
    if not (np.array_equal(iu[0], ref_iu[0])
            and np.array_equal(iu[1], ref_iu[1])):
        raise ValueError("kernel B2's packed entry takes the pairs in the "
                         "order of linalg.triu_pairs")
    return starts


_ROW_STARTS: dict = {}


def _row_starts_on(k: int, iu, device) -> torch.Tensor:
    starts = packed_row_starts(k, iu)
    key = (int(k), str(device))
    if key not in _ROW_STARTS:
        _ROW_STARTS[key] = torch.as_tensor(starts, device=device)
    return _ROW_STARTS[key]


def packed_inv_diag(a_full, packed_t, starts) -> torch.Tensor:
    """(k, n) reciprocals of the per-column diagonals ``a_full[i, i] -
    packed_t[pos(i, i), c]`` (``starts``: ``packed_row_starts``): the plain
    version of the 1/diag that B2's packed entry forms in the kernel
    (``__frcp_rn`` of the ``__fsub_rn``, both correctly rounded), and the
    subtraction and division of ``1 / unpack_sym_from_t(...)[i, i, :]``,
    so the same bits."""
    idx = torch.as_tensor(starts, device=packed_t.device).long()
    return 1.0 / (torch.diagonal(a_full)[:, None] - packed_t[idx])


def nnls_batch_cuda_batched_packed_t(a_full, packed_t, iu, B, X0, L1=0.0,
                                     L2=0.0, update_mask=None,
                                     max_sweeps: int = CD_MAX_SWEEPS,
                                     n_coord=None,
                                     sweep_cap=None) -> torch.Tensor:
    """``nnls_batch`` for per-column float32 Grams ``a_c[j, i] = a_full[i,
    j] - packed_t[pos(i, j), c]`` (``linalg.unpack_sym_from_t``'s), from
    a_full (k, k) and the packed corrections packed_t (npairs, n) in the
    order of ``iu`` (``linalg.triu_pairs(k)``), and scalar L1/L2.

    B, X0: (n, k); update_mask: bool (n,) or None. Returns X (n, k); rows
    with update_mask False equal X0 bit for bit. On a CUDA tensor kernel
    B2 reads a_full and packed_t in place and forms 1/diag itself
    (``packed_inv_diag`` is its plain version), and nothing writes the
    (k, k, n) tile; on the CPU this is the plain version on the unpacked
    Grams.
    """
    n, k = B.shape
    if B.device.type != "cuda":
        at = linalg.unpack_sym_from_t(packed_t, k, iu, a_full)
        return nnls_batch(at.permute(2, 1, 0), B, X0, L1=L1, L2=L2,
                          update_mask=update_mask, max_sweeps=max_sweeps,
                          n_coord=n_coord, sweep_cap=sweep_cap)
    global LAUNCHES_BATCHED
    if k > MAX_K_BATCHED:
        raise NotImplementedError(
            f"kernel B2 takes k <= {MAX_K_BATCHED}, got {k}")
    _check("a_full", a_full, (k, k), torch.float32, B.device)
    _check("packed_t", packed_t, (k * (k + 1) // 2, n), torch.float32,
           B.device)
    _check_common(B, X0, update_mask, L1, "B2")
    starts = _row_starts_on(k, iu, B.device)
    k_div = float(k if n_coord is None else n_coord)
    X = torch.empty_like(B)
    if n == 0:
        return X
    _launch(_kernel("nnls_cd_batched", "nnls_cd_batched_packed",
                    _ARGTYPES_PACKED), "nnls_cd_batched_packed",
            (a_full, packed_t, starts), B, X0, update_mask, X, L1, L2, k_div,
            _cap(max_sweeps, sweep_cap), max_sweeps)
    LAUNCHES_BATCHED += 1
    return X

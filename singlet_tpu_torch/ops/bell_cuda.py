"""Kernels B3 and B4: blocked-ELL SpMM, hand-written in CUDA.

B3 (``bell_spmm_cuda``) replaces ``singlet_tpu/ops/pallas_bell.py``
``bell_spmm`` and B4 (``bell_spmm_t_cuda``) replaces ``bell_spmm_t``, both
in their plain and in their masked (in-kernel hashed keep factor) forms.
Their source is ``csrc/bell_spmm.cu``, whose header note gives the design
and what bounds it on the card; ``_build.py`` compiles it with nvcc at first
use and this module binds it with ctypes.

On a CUDA tensor each wrapper launches its kernel or raises; on a CPU
tensor it runs the plain version (``ops/bell.py``), because there is no
card to launch on. Importing this module needs neither nvcc nor a card.
"""

from __future__ import annotations

import ctypes

import torch

from singlet_tpu_torch.ops.bell import bell_spmm_plain, bell_spmm_t_plain
from singlet_tpu_torch.ops.nnls_cuda import _check

# kernel launches (one per wrapper call on CUDA tensors) of B3 and of B4;
# read by chip_smoke.py to show that a fit went through the kernels
LAUNCHES_SPMM = 0
LAUNCHES_SPMM_T = 0

# B3 keeps a cell's k outputs in registers, up to 7 per lane
MAX_K = 224
# B4 keeps a (gene_block, 32) float tile and three 32 x 32 staging tiles
# in shared memory, within the 232,448 bytes a Hopper block may use
MAX_GENE_BLOCK = (232448 // 4 - 3 * 32 * 32) // 32
# B4 splits the cells into chunks until the grid has about this many
# blocks (a function of the shapes only, so the sums are always the same)
_B4_TARGET_BLOCKS = 1024
_B4_MIN_CHUNK = 256

_LIB = {}


def _lib():
    if not _LIB:
        from singlet_tpu_torch import _build

        lib = _build.load("bell_spmm")
        common = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong,
                  ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                  ctypes.c_void_p, ctypes.c_int]
        tail = [ctypes.c_int, ctypes.c_uint64, ctypes.c_longlong,
                ctypes.c_int, ctypes.c_void_p]
        lib.bell_spmm.argtypes = common + [ctypes.c_void_p] + tail
        lib.bell_spmm.restype = ctypes.c_int
        lib.bell_spmm_t.argtypes = common + [
            ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
            ctypes.c_void_p] + tail
        lib.bell_spmm_t.restype = ctypes.c_int
        lib.bell_spmm_error_string.argtypes = [ctypes.c_int]
        lib.bell_spmm_error_string.restype = ctypes.c_char_p
        _LIB["lib"] = lib
    return _LIB["lib"]


def _check_planes(b_li, b_val, n_gb, device):
    """The planes may be a column slice of the engine's planes: cells must
    be contiguous (stride 1), rows any stride, both planes alike."""
    for name, t, dtype in (("b_li", b_li, torch.int32),
                           ("b_val", b_val, torch.float32)):
        if t.device != device:
            raise ValueError(f"{name} is on {t.device}, expected {device}")
        if t.dtype != dtype:
            raise TypeError(f"{name} has dtype {t.dtype}, expected {dtype}")
        if t.dim() != 2 or t.stride(1) != 1:
            raise ValueError(f"{name} must be 2-D with contiguous cells "
                             "(stride 1 on its last axis)")
    if b_li.shape != b_val.shape or b_li.stride() != b_val.stride():
        raise ValueError("b_li and b_val must have one shape and strides")
    if b_li.shape[0] % n_gb:
        raise ValueError(f"{b_li.shape[0]} plane rows do not split into "
                         f"{n_gb} gene blocks")


def _seed_args(seed, inv_density):
    if int(inv_density) < 1:
        raise ValueError(f"inv_density must be >= 1, got {inv_density}")
    if seed is None:
        return 0, 0
    hi, lo = int(seed[0]), int(seed[1])
    return 1, ((hi & 0xFFFFFFFF) << 32) | (lo & 0xFFFFFFFF)


def _raise_on(err, symbol):
    if err != 0:
        msg = _lib().bell_spmm_error_string(err).decode()
        raise RuntimeError(f"{symbol} launch failed: {msg} ({err})")


def bell_spmm_cuda(b_li, b_val, W, seed=None, cell_offset: int = 0, *,
                   gene_block: int, inv_density: int = 20) -> torch.Tensor:
    """Kernel B3: B (cells, k) = the (keep-masked, with ``seed``) product
    of the planes with W (n_gb * gene_block, k). On CPU tensors, the plain
    version."""
    if W.device.type != "cuda":
        return bell_spmm_plain(b_li, b_val, W, seed, cell_offset,
                               gene_block=gene_block,
                               inv_density=inv_density)
    global LAUNCHES_SPMM
    rows_w, k = W.shape
    if rows_w % gene_block:
        raise ValueError(f"W has {rows_w} rows, not a multiple of "
                         f"gene_block {gene_block}")
    if k > MAX_K:
        raise NotImplementedError(f"kernel B3 takes k <= {MAX_K}, got {k}")
    n_gb = rows_w // gene_block
    _check("W", W, (rows_w, k), torch.float32, W.device)
    _check_planes(b_li, b_val, n_gb, W.device)
    masked, seed64 = _seed_args(seed, inv_density)
    cells = b_li.shape[1]
    B = torch.empty((cells, k), dtype=torch.float32, device=W.device)
    if cells == 0:
        return B
    with torch.cuda.device(W.device):
        stream = torch.cuda.current_stream(W.device).cuda_stream
        err = _lib().bell_spmm(
            b_li.data_ptr(), b_val.data_ptr(), b_li.stride(0), n_gb,
            b_li.shape[0] // n_gb, cells, gene_block, W.data_ptr(), k,
            B.data_ptr(), masked, seed64, int(cell_offset),
            int(inv_density), stream)
    _raise_on(err, "bell_spmm")
    LAUNCHES_SPMM += 1
    return B


def b4_chunks(cells: int, n_gb: int, k: int):
    """(n_chunks, chunk): B4's split of the cells, from the shapes only."""
    base = n_gb * ((k + 31) // 32)
    max_chunks = max(1, -(-cells // _B4_MIN_CHUNK))
    n_chunks = min(max_chunks, max(1, -(-_B4_TARGET_BLOCKS // base)), 65535)
    chunk = -(-max(cells, 1) // n_chunks)
    chunk = -(-chunk // 32) * 32
    return -(-max(cells, 1) // chunk), chunk


def bell_spmm_t_cuda(b_li, b_val, H, seed=None, cell_offset: int = 0, *,
                     gene_block: int, n_gb: int,
                     inv_density: int = 20) -> torch.Tensor:
    """Kernel B4: Bw (n_gb * gene_block, k) = the (keep-masked) transposed
    product of the planes with H (cells, k), deterministic. On CPU tensors,
    the plain version."""
    if H.device.type != "cuda":
        return bell_spmm_t_plain(b_li, b_val, H, seed, cell_offset,
                                 gene_block=gene_block, n_gb=n_gb,
                                 inv_density=inv_density)
    global LAUNCHES_SPMM_T
    if gene_block > MAX_GENE_BLOCK:
        raise NotImplementedError(
            f"kernel B4 takes gene_block <= {MAX_GENE_BLOCK}, got "
            f"{gene_block}")
    cells = b_li.shape[1]
    k = H.shape[1]
    _check("H", H, (cells, k), torch.float32, H.device)
    _check_planes(b_li, b_val, n_gb, H.device)
    masked, seed64 = _seed_args(seed, inv_density)
    genes = n_gb * gene_block
    Bw = torch.empty((genes, k), dtype=torch.float32, device=H.device)
    if cells == 0:
        return Bw.zero_()
    n_chunks, chunk = b4_chunks(cells, n_gb, k)
    partials = (torch.empty((n_chunks, genes, k), dtype=torch.float32,
                            device=H.device) if n_chunks > 1 else None)
    with torch.cuda.device(H.device):
        stream = torch.cuda.current_stream(H.device).cuda_stream
        err = _lib().bell_spmm_t(
            b_li.data_ptr(), b_val.data_ptr(), b_li.stride(0), n_gb,
            b_li.shape[0] // n_gb, cells, gene_block, H.data_ptr(), k,
            None if partials is None else partials.data_ptr(), n_chunks,
            chunk, Bw.data_ptr(), masked, seed64, int(cell_offset),
            int(inv_density), stream)
    _raise_on(err, "bell_spmm_t")
    LAUNCHES_SPMM_T += 1
    return Bw

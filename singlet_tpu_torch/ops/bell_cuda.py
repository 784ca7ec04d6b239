"""Kernels B3-B7: blocked-ELL SpMM and the fused test MSE, hand-written in
CUDA.

B3 (``bell_spmm_cuda``) replaces ``singlet_tpu/ops/pallas_bell.py``
``bell_spmm`` and B4 (``bell_spmm_t_cuda``) replaces ``bell_spmm_t``, both
in their plain and in their masked (in-kernel hashed keep factor) forms; B5
(``bell_spmm_bits_cuda``) and B6 (``bell_spmm_t_bits_cuda``) replace
``bell_spmm_bits`` and ``bell_spmm_t_bits``: the same two kernels with the
keep factor read from the packed test-mask words. Their source is
``csrc/bell_spmm.cu``. B7 (``bell_mse_bits_cuda``) replaces
``bell_mse_bits``; its source is ``csrc/bell_mse_bits.cu``. Each source's
header note gives the design and what bounds it on the card; ``_build.py``
compiles them with nvcc at first use and this module binds them with
ctypes.

On a CUDA tensor each wrapper launches its kernel or raises; on a CPU
tensor it runs the plain version (``ops/bell.py``), because there is no
card to launch on. Importing this module needs neither nvcc nor a card.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch

from singlet_tpu_torch.ops.bell import (bell_mse_bits_plain,
                                        bell_spmm_bits_plain,
                                        bell_spmm_plain,
                                        bell_spmm_t_bits_plain,
                                        bell_spmm_t_plain)
from singlet_tpu_torch.ops.nnls_cuda import _check

# kernel launches on CUDA tensors of B3 and of B4 (one per wrapper call
# with cells; B3 and B5 one per column chunk of W); read by chip_smoke.py
# to show that a fit went through the kernels
LAUNCHES_SPMM = 0
LAUNCHES_SPMM_T = 0
# likewise B5, B6 and B7
LAUNCHES_SPMM_BITS = 0
LAUNCHES_SPMM_T_BITS = 0
LAUNCHES_MSE_BITS = 0

# B3 keeps a cell's k outputs in registers, up to 7 per lane: a wider W is
# split into chunks of at most this many columns, one launch each. Each
# output column is one thread's sum over the cell's live slots in slot
# order whatever the other columns, so the chunks give the bits of one
# launch and B3/B5 take any k
B3_K_CHUNK = 224
# B7 keeps a cell's H row in registers, up to 16 per lane
MAX_K_MSE = 512
# B7 keeps one dense float row of gene_block per warp, eight warps
MAX_GENE_BLOCK_MSE = 232448 // (8 * 4)

# B4's plan (csrc/bell_spmm.cu): 20 warps a block, each holding the
# outputs of 26 gene rows at 1 or 2 adjacent columns a lane (k <= 64) or of
# 13 at 4; output columns in tiles of 128; cells in tiles of 64, of which
# the first 32 slot rows are staged in shared memory; and in chunks until
# there is about one block per SM of an H100 (at most 16, which bounds the
# chunks' scratch)
_B4_WARPS = 20
_B4_GENES = {1: 26, 2: 26, 4: 13}
_B4_COLS = 128
_B4_TILE = 64
_B4_WIN_ROWS = 32
_B4_SMS = 132
_B4_MAX_CHUNKS = 16


class B4Plan(NamedTuple):
    """B4's split of one call's work (see ``b4_plan``)."""
    vec: int           # adjacent output columns a lane: 1, 2 or 4
    rows: int          # gene rows a block (a row group of a gene block)
    n_rg: int          # row groups a gene block
    n_kt: int          # column tiles of at most 128
    tile: int          # cells a tile
    chunk_tiles: int   # tiles a chunk of cells
    n_chunks: int
    smem: int          # dynamic shared memory a block, bytes


def _b4_vec(k: int) -> int:
    """Adjacent output columns a lane of B4 holds: 1, 2 or 4, for column
    tiles of at most 32, 64 or 128."""
    cols = min(k, _B4_COLS)
    return 1 if cols <= 32 else 2 if cols <= 64 else 4


def b4_smem(rows: int, k: int) -> int:
    """Bytes of B4's dynamic shared memory (bell_spmm.cu
    ``b4_smem_bytes``): a window of 32 slot rows (ids and values), the
    (rows, tile) values, two (rows, tile) bitmaps, two H tiles (rows
    rounded up to 16 bytes, plus the last row's over-read) and four
    flags."""
    cols = min(k, _B4_COLS)
    h_floats = _B4_TILE * (-(-cols // 4) * 4) + 32 * _b4_vec(k)
    return (2 * h_floats * 4 + _B4_WIN_ROWS * _B4_TILE * 8
            + rows * _B4_TILE * 4 + 2 * rows * (_B4_TILE // 32) * 4 + 16)


@functools.lru_cache(maxsize=256)
def b4_plan(cells: int, n_gb: int, gene_block: int, k: int) -> B4Plan:
    """B4's plan, from the shapes alone: each gene block in row groups of
    at most 20 warps x 26 or 13 rows, k in column tiles of 128, the cells in
    tiles of 64 and in chunks of tiles. Every output's sum runs over its
    live cells in cell order within a chunk and over the chunks in order,
    so the plan fixes the bits of the result."""
    vec = _b4_vec(k)
    n_rg = -(-gene_block // (_B4_WARPS * _B4_GENES[vec]))
    rows = -(-gene_block // n_rg)
    n_kt = -(-k // _B4_COLS)
    n_tiles = max(1, -(-cells // _B4_TILE))
    per_chunk = n_gb * n_rg * n_kt
    n_chunks = max(1, min(_B4_MAX_CHUNKS, _B4_SMS // per_chunk, n_tiles))
    chunk_tiles = -(-n_tiles // n_chunks)
    return B4Plan(vec, rows, n_rg, n_kt, _B4_TILE, chunk_tiles,
                  -(-n_tiles // chunk_tiles), b4_smem(rows, k))


_LIB = {}


def _lib():
    if "lib" not in _LIB:
        from singlet_tpu_torch import _build

        lib = _build.load("bell_spmm")
        common = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong,
                  ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                  ctypes.c_void_p, ctypes.c_int]
        # keep mode, seed, cell offset, inv_density, words, words' row
        # stride, stream
        tail = [ctypes.c_int, ctypes.c_uint64, ctypes.c_longlong,
                ctypes.c_int, ctypes.c_void_p, ctypes.c_longlong,
                ctypes.c_void_p]
        lib.bell_spmm.argtypes = common + [ctypes.c_void_p] + tail
        lib.bell_spmm.restype = ctypes.c_int
        # Bw, partials, counters; rows, chunk_tiles, n_chunks, h_vec, p_vec
        lib.bell_spmm_t.argtypes = common + [ctypes.c_void_p] * 3 + [
            ctypes.c_int] * 5 + tail
        lib.bell_spmm_t.restype = ctypes.c_int
        lib.bell_spmm_error_string.argtypes = [ctypes.c_int]
        lib.bell_spmm_error_string.restype = ctypes.c_char_p
        _LIB["lib"] = lib
    return _LIB["lib"]


def _mse_lib():
    if "mse" not in _LIB:
        from singlet_tpu_torch import _build

        lib = _build.load("bell_mse_bits")
        vp, ci, cl = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        lib.bell_mse_bits.argtypes = [vp, vp, cl, ci, ci, ci, ci, vp, cl, vp,
                                      vp, ci, vp, vp]
        lib.bell_mse_bits.restype = ci
        lib.bell_mse_bits_error_string.argtypes = [ci]
        lib.bell_mse_bits_error_string.restype = ctypes.c_char_p
        _LIB["mse"] = lib
    return _LIB["mse"]


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


def _check_words(words, cells, n_gb, gene_block, device):
    """The packed test-mask words of the planes' cells: (cells, n_t *
    gene_block) int32, rows contiguous (a row slice of the engine's words
    is)."""
    wcols = -(-n_gb // 32) * gene_block
    if words.device != device:
        raise ValueError(f"words is on {words.device}, expected {device}")
    if words.dtype != torch.int32:
        raise TypeError(f"words has dtype {words.dtype}, expected "
                        "torch.int32")
    if tuple(words.shape) != (cells, wcols) or not words.is_contiguous():
        raise ValueError(f"words must be contiguous ({cells}, {wcols}), got "
                         f"{tuple(words.shape)}")


def _raise_on(err, symbol, error_string=None):
    if err != 0:
        error_string = error_string or _lib().bell_spmm_error_string
        msg = error_string(err).decode()
        raise RuntimeError(f"{symbol} launch failed: {msg} ({err})")


def _launch_b3(b_li, b_val, W, mode, seed64, cell_offset, inv_density,
               words, *, gene_block: int) -> tuple[torch.Tensor, int]:
    """bell_spmm.cu's ``bell_spmm`` (B3 with keep mode 0 or 1, B5 with mode
    2), one launch per chunk of at most ``B3_K_CHUNK`` columns of W; checks
    its arguments and returns B (cells, k) and the number of launches."""
    rows_w, k = W.shape
    if rows_w % gene_block:
        raise ValueError(f"W has {rows_w} rows, not a multiple of "
                         f"gene_block {gene_block}")
    n_gb = rows_w // gene_block
    _check("W", W, (rows_w, k), torch.float32, W.device)
    _check_planes(b_li, b_val, n_gb, W.device)
    cells = b_li.shape[1]
    if words is not None:
        _check_words(words, cells, n_gb, gene_block, W.device)
    B = torch.empty((cells, k), dtype=torch.float32, device=W.device)
    if cells == 0:
        return B, 0
    chunks = range(0, k, B3_K_CHUNK)
    for c0 in chunks:
        kc = min(B3_K_CHUNK, k - c0)
        Wc = W if kc == k else W[:, c0:c0 + kc].contiguous()
        Bc = B if kc == k else torch.empty((cells, kc), dtype=torch.float32,
                                           device=W.device)
        with torch.cuda.device(W.device):
            stream = torch.cuda.current_stream(W.device).cuda_stream
            err = _lib().bell_spmm(
                b_li.data_ptr(), b_val.data_ptr(), b_li.stride(0), n_gb,
                b_li.shape[0] // n_gb, cells, gene_block, Wc.data_ptr(), kc,
                Bc.data_ptr(), mode, seed64, int(cell_offset),
                int(inv_density), None if words is None else words.data_ptr(),
                0 if words is None else words.stride(0), stream)
        _raise_on(err, "bell_spmm")
        if Bc is not B:
            B[:, c0:c0 + kc] = Bc
    return B, len(chunks)


def bell_spmm_cuda(b_li, b_val, W, seed=None, cell_offset: int = 0, *,
                   gene_block: int, inv_density: int = 20) -> torch.Tensor:
    """Kernel B3: B (cells, k) = the (keep-masked, with ``seed``) product
    of the planes with W (n_gb * gene_block, k), in chunks of at most
    ``B3_K_CHUNK`` columns (one launch each, each counted). On CPU
    tensors, the plain version."""
    if W.device.type != "cuda":
        return bell_spmm_plain(b_li, b_val, W, seed, cell_offset,
                               gene_block=gene_block,
                               inv_density=inv_density)
    global LAUNCHES_SPMM
    masked, seed64 = _seed_args(seed, inv_density)
    B, launches = _launch_b3(b_li, b_val, W, masked, seed64, cell_offset,
                             inv_density, None, gene_block=gene_block)
    LAUNCHES_SPMM += launches
    return B


def bell_spmm_bits_cuda(b_li, b_val, W, words, *,
                        gene_block: int) -> torch.Tensor:
    """Kernel B5: B3 keep-masked by the test bits of ``words`` (cells, n_t *
    gene_block) int32, the packed mask of the planes' cells, launched in
    column chunks as B3. On CPU tensors, the plain version."""
    if W.device.type != "cuda":
        return bell_spmm_bits_plain(b_li, b_val, W, words,
                                    gene_block=gene_block)
    global LAUNCHES_SPMM_BITS
    B, launches = _launch_b3(b_li, b_val, W, 2, 0, 0, 1, words,
                             gene_block=gene_block)
    LAUNCHES_SPMM_BITS += launches
    return B


def _h_vec(H: torch.Tensor, k: int) -> int:
    """Floats per cp.async of H in B4: 4 or 2 where k and H's address
    allow, else 1."""
    for vec in (4, 2):
        if k % vec == 0 and H.data_ptr() % (4 * vec) == 0:
            return vec
    return 1


def _p_vec(b_li, b_val) -> int:
    """Cells per cp.async of the planes in B4: 4 where the row stride and
    both planes' addresses allow, else 1."""
    aligned = (b_li.stride(0) % 4 == 0 and b_li.data_ptr() % 16 == 0
               and b_val.data_ptr() % 16 == 0)
    return 4 if aligned else 1


def _launch_b4(b_li, b_val, H, mode, seed64, cell_offset, inv_density, words,
               *, gene_block: int, n_gb: int) -> tuple[torch.Tensor, int]:
    """One launch of bell_spmm.cu's ``bell_spmm_t`` (B4 with keep mode 0
    or 1, B6 with mode 2) on ``b4_plan``; returns Bw (n_gb * gene_block, k)
    and the number of launches (0 without cells or columns)."""
    cells = b_li.shape[1]
    k = H.shape[1]
    _check("H", H, (cells, k), torch.float32, H.device)
    _check_planes(b_li, b_val, n_gb, H.device)
    if words is not None:
        _check_words(words, cells, n_gb, gene_block, H.device)
    genes = n_gb * gene_block
    if cells == 0 or k == 0 or genes == 0:
        return torch.zeros((genes, k), dtype=torch.float32,
                           device=H.device), 0
    plan = b4_plan(cells, n_gb, gene_block, k)
    size = genes * k
    if plan.n_chunks == 1:
        Bw = torch.empty((genes, k), dtype=torch.float32, device=H.device)
        partials = counters = None
    else:
        # one allocation: Bw, the chunks' partial tiles, then one int32
        # counter per output tile (Bw is a view of its first genes * k)
        buf = torch.empty((1 + plan.n_chunks) * size
                          + n_gb * plan.n_rg * plan.n_kt,
                          dtype=torch.float32, device=H.device)
        Bw = buf[:size].view(genes, k)
        partials = buf.data_ptr() + 4 * size
        counters = partials + 4 * plan.n_chunks * size
    with torch.cuda.device(H.device):
        stream = torch.cuda.current_stream(H.device).cuda_stream
        err = _lib().bell_spmm_t(
            b_li.data_ptr(), b_val.data_ptr(), b_li.stride(0), n_gb,
            b_li.shape[0] // n_gb, cells, gene_block, H.data_ptr(), k,
            Bw.data_ptr(), partials, counters, plan.rows, plan.chunk_tiles,
            plan.n_chunks, _h_vec(H, k),
            _p_vec(b_li, b_val), mode,
            seed64, int(cell_offset), int(inv_density),
            None if words is None else words.data_ptr(),
            0 if words is None else words.stride(0), stream)
    _raise_on(err, "bell_spmm_t")
    return Bw, 1


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
    masked, seed64 = _seed_args(seed, inv_density)
    Bw, launches = _launch_b4(b_li, b_val, H, masked, seed64, cell_offset,
                              inv_density, None, gene_block=gene_block,
                              n_gb=n_gb)
    LAUNCHES_SPMM_T += launches
    return Bw


def bell_spmm_t_bits_cuda(b_li, b_val, H, words, *, gene_block: int,
                          n_gb: int) -> torch.Tensor:
    """Kernel B6: B4 keep-masked by the test bits of ``words``. On CPU
    tensors, the plain version."""
    if H.device.type != "cuda":
        return bell_spmm_t_bits_plain(b_li, b_val, H, words,
                                      gene_block=gene_block, n_gb=n_gb)
    global LAUNCHES_SPMM_T_BITS
    Bw, launches = _launch_b4(b_li, b_val, H, 2, 0, 0, 1, words,
                              gene_block=gene_block, n_gb=n_gb)
    LAUNCHES_SPMM_T_BITS += launches
    return Bw


def bell_mse_bits_cuda(b_li, b_val, words, Wd, H, *,
                       gene_block: int) -> torch.Tensor:
    """Kernel B7: (2, cells) float32, per cell the squared error summed
    over its held-out genes (row 0) and their count (row 1), the mask read
    from ``words``; Wd (n_gb * gene_block, k), H (cells, k). On CPU
    tensors, the plain version."""
    if H.device.type != "cuda":
        return bell_mse_bits_plain(b_li, b_val, words, Wd, H,
                                   gene_block=gene_block)
    global LAUNCHES_MSE_BITS
    rows_w, k = Wd.shape
    if rows_w % gene_block:
        raise ValueError(f"Wd has {rows_w} rows, not a multiple of "
                         f"gene_block {gene_block}")
    if k > MAX_K_MSE:
        raise NotImplementedError(f"kernel B7 takes k <= {MAX_K_MSE}, got "
                                  f"{k}")
    if gene_block > MAX_GENE_BLOCK_MSE:
        raise NotImplementedError(f"kernel B7 takes gene_block <= "
                                  f"{MAX_GENE_BLOCK_MSE}, got {gene_block}")
    n_gb = rows_w // gene_block
    cells = b_li.shape[1]
    dev = H.device
    _check("Wd", Wd, (rows_w, k), torch.float32, dev)
    _check("H", H, (cells, k), torch.float32, dev)
    _check_planes(b_li, b_val, n_gb, dev)
    _check_words(words, cells, n_gb, gene_block, dev)
    out = torch.empty((2, cells), dtype=torch.float32, device=dev)
    if cells == 0:
        return out
    lib = _mse_lib()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.bell_mse_bits(
            b_li.data_ptr(), b_val.data_ptr(), b_li.stride(0), n_gb,
            b_li.shape[0] // n_gb, cells, gene_block, words.data_ptr(),
            words.stride(0), Wd.data_ptr(), H.data_ptr(), k, out.data_ptr(),
            stream)
    _raise_on(err, "bell_mse_bits", lib.bell_mse_bits_error_string)
    LAUNCHES_MSE_BITS += 1
    return out

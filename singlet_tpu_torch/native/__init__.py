"""ctypes bindings for the native IO library (``singlet_io.cpp``).

Port of ``singlet_tpu/native/__init__.py``. The C++ source sits beside this
file and is built at first use with ``g++`` and the JAX package's Makefile
flags (``CXX_FLAGS``, ``LD_FLAGS``) into the git-ignored
``build/singlet_tpu_torch/`` at the root of the checkout, under a file name
that carries a hash of the source, the flags, the compiler's version and
the target that ``-march=native`` resolves to on this host: a library built
on another host is never loaded. Nothing is built into the package
directory.

Every entry point keeps the JAX package's fallback when the library cannot
be built or loaded (no ``g++``, no zlib headers): numpy or scipy, and
``.npz`` shards in place of SVC files, named as the JAX package names them
so that staged directories cross between the packages. The shard format is
the JAX package's byte for byte. ``csc_to_bell``'s numpy fallback is the
port's packer of the earlier slices, unchanged.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Optional, Tuple

import numpy as np
import scipy.sparse as sp

SOURCE = Path(__file__).resolve().parent / "singlet_io.cpp"
BUILD_DIR = SOURCE.parents[2] / "build" / "singlet_tpu_torch"
CXX_FLAGS = ("-O3", "-march=native", "-fPIC", "-std=c++17", "-Wall")
LD_FLAGS = ("-shared", "-lz", "-lpthread")

# the loaded library; False once a build or load has failed in this process
_LIB = None

_i32p = ctypes.POINTER(ctypes.c_int32)
_i64p = ctypes.POINTER(ctypes.c_int64)
_f32p = ctypes.POINTER(ctypes.c_float)
_i64 = ctypes.c_int64


class _MtxResult(ctypes.Structure):
    _fields_ = [
        ("rows", ctypes.c_int64),
        ("cols", ctypes.c_int64),
        ("nnz", ctypes.c_int64),
        ("coo_row", _i32p),
        ("coo_col", _i32p),
        ("coo_val", _f32p),
    ]


# (restype, argtypes) of every export of singlet_io.cpp
_SIGNATURES = {
    "singlet_last_error": (ctypes.c_char_p, ()),
    "singlet_mtx_read": (ctypes.c_int, (ctypes.c_char_p,
                                        ctypes.POINTER(_MtxResult))),
    "singlet_free": (None, (ctypes.c_void_p,)),
    "singlet_coo_to_csc": (ctypes.c_int, (_i64, _i64, _i64, _i32p, _i32p,
                                          _f32p, _i64p, _i32p, _f32p)),
    "singlet_csc_transpose": (ctypes.c_int, (_i64, _i64, _i64p, _i32p,
                                             _f32p, _i64p, _i32p, _f32p)),
    "singlet_csc_to_ell": (ctypes.c_int, (_i64, _i64, _i64, ctypes.c_int32,
                                          _i64p, _i32p, _f32p, _i32p,
                                          _f32p)),
    "singlet_csc_to_bell": (ctypes.c_int, (_i64, _i64, _i64, _i64, _i64,
                                           _i64p, _i32p, _f32p, _i32p,
                                           _f32p)),
    "singlet_log_normalize": (ctypes.c_int, (_i64, _i64p, _f32p,
                                             ctypes.c_double)),
    "singlet_svc_write": (ctypes.c_int, (ctypes.c_char_p, _i64, _i64, _i64p,
                                         _i32p, _f32p)),
    "singlet_svc_write_v2": (ctypes.c_int, (ctypes.c_char_p, _i64, _i64,
                                            _i64p, _i32p, _f32p)),
    "singlet_svc_read_header": (ctypes.c_int, (ctypes.c_char_p, _i64p,
                                               _i64p, _i64p)),
    "singlet_svc_read": (ctypes.c_int, (ctypes.c_char_p, _i64p, _i32p,
                                        _f32p)),
}


def find_cxx() -> str:
    """Path of the C++ compiler: ``$CXX``, else ``g++`` on PATH."""
    found = shutil.which(os.environ.get("CXX", "g++"))
    if not found:
        raise RuntimeError("g++ not found (CXX, PATH); the native IO library "
                           "is built from source at first use")
    return found


def _host_target(cxx: str) -> bytes:
    """The compiler's version and the cc1plus command line that
    ``-march=native`` expands to on this host (its CPU's architecture and
    features)."""
    version = subprocess.run([cxx, "--version"], capture_output=True,
                             check=True, timeout=60).stdout
    expand = subprocess.run([cxx, *CXX_FLAGS, "-###", "-x", "c++", "-E",
                             os.devnull], capture_output=True, check=True,
                            timeout=60).stderr
    return version + b"\n".join(ln for ln in expand.splitlines()
                                if b"cc1plus" in ln)


def library_path(cxx: str) -> Path:
    """Where the library built by ``cxx`` on this host lives: its name
    carries a hash of the source, the flags and ``_host_target``."""
    h = hashlib.sha256()
    h.update(SOURCE.read_bytes())
    h.update(" ".join(CXX_FLAGS + LD_FLAGS).encode())
    h.update(_host_target(cxx))
    return BUILD_DIR / f"libsinglet_io_{h.hexdigest()[:16]}.so"


def build() -> Tuple[Path, float, str]:
    """Compile ``singlet_io.cpp`` unless a library of the same hash
    (``library_path``) exists. Returns (library path, seconds spent
    compiling, compiler log); a missing compiler or a failed build
    raises."""
    cxx = find_cxx()
    lib = library_path(cxx)
    if lib.is_file():
        return lib, 0.0, ""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_name(f"{lib.name}.{os.getpid()}.tmp")
    t0 = time.perf_counter()
    proc = subprocess.run([cxx, *CXX_FLAGS, str(SOURCE), "-o", str(tmp),
                           *LD_FLAGS], capture_output=True, text=True,
                          timeout=600)
    seconds = time.perf_counter() - t0
    log = proc.stdout + proc.stderr
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"{cxx} failed on {SOURCE} (rc {proc.returncode})"
                           f":\n{log}")
    os.replace(tmp, lib)    # atomic: concurrent builders see whole files only
    return lib, seconds, log


def _load() -> Optional[ctypes.CDLL]:
    """The loaded library, built on first use; None where it cannot be
    built or loaded (the fallbacks then run)."""
    global _LIB
    if _LIB is None:
        try:
            lib = ctypes.CDLL(str(build()[0]))
        except (RuntimeError, OSError, subprocess.SubprocessError):
            _LIB = False
            return None
        for name, (restype, argtypes) in _SIGNATURES.items():
            fn = getattr(lib, name)
            fn.restype, fn.argtypes = restype, argtypes
        _LIB = lib
    return _LIB or None


def available() -> bool:
    return _load() is not None


def _ptr(arr, ctype):
    return arr.ctypes.data_as(ctypes.POINTER(ctype))


def _csc_arrays(A: sp.csc_matrix):
    """indptr int64, indices int32, data float32, each contiguous."""
    return (np.ascontiguousarray(A.indptr, np.int64),
            np.ascontiguousarray(A.indices, np.int32),
            np.ascontiguousarray(A.data, np.float32))


def _check(lib, rc: int, exc=IOError) -> None:
    if rc != 0:
        raise exc(lib.singlet_last_error().decode())


def read_mtx(path: str) -> sp.csc_matrix:
    """Fast MatrixMarket reader (plain or .gz). Falls back to scipy.io."""
    lib = _load()
    if lib is None:
        import scipy.io
        return scipy.io.mmread(path).tocsc().astype(np.float32)
    res = _MtxResult()
    _check(lib, lib.singlet_mtx_read(path.encode(), ctypes.byref(res)))
    n = res.nnz
    try:
        row = np.ctypeslib.as_array(res.coo_row, (n,)).copy()
        col = np.ctypeslib.as_array(res.coo_col, (n,)).copy()
        val = np.ctypeslib.as_array(res.coo_val, (n,)).copy()
    finally:
        lib.singlet_free(res.coo_row)
        lib.singlet_free(res.coo_col)
        lib.singlet_free(res.coo_val)
    indptr = np.zeros(res.cols + 1, np.int64)
    indices = np.zeros(n, np.int32)
    data = np.zeros(n, np.float32)
    lib.singlet_coo_to_csc(res.rows, res.cols, n, _ptr(row, ctypes.c_int32),
                           _ptr(col, ctypes.c_int32),
                           _ptr(val, ctypes.c_float),
                           _ptr(indptr, ctypes.c_int64),
                           _ptr(indices, ctypes.c_int32),
                           _ptr(data, ctypes.c_float))
    return sp.csc_matrix((data, indices, indptr), shape=(res.rows, res.cols))


def csc_transpose(A: sp.csc_matrix) -> sp.csc_matrix:
    """O(nnz) transpose returning CSC of A.T. Fallback: scipy."""
    lib = _load()
    if lib is None:
        return A.T.tocsc()
    A = sp.csc_matrix(A)
    rows, cols = A.shape
    indptr, indices, data = _csc_arrays(A)
    t_indptr = np.zeros(rows + 1, np.int64)
    t_indices = np.zeros(A.nnz, np.int32)
    t_data = np.zeros(A.nnz, np.float32)
    lib.singlet_csc_transpose(rows, cols, _ptr(indptr, ctypes.c_int64),
                              _ptr(indices, ctypes.c_int32),
                              _ptr(data, ctypes.c_float),
                              _ptr(t_indptr, ctypes.c_int64),
                              _ptr(t_indices, ctypes.c_int32),
                              _ptr(t_data, ctypes.c_float))
    return sp.csc_matrix((t_data, t_indices, t_indptr), shape=(cols, rows))


def csc_to_ell(A: sp.csc_matrix, cols_pad: int, max_nnz: int,
               pad_row: int) -> Tuple[np.ndarray, np.ndarray]:
    """CSC -> ELL planes (parallel). Fallback: python loop."""
    lib = _load()
    A = sp.csc_matrix(A)
    cols = A.shape[1]
    if lib is None:
        idx = np.full((cols_pad, max_nnz), pad_row, np.int32)
        val = np.zeros((cols_pad, max_nnz), np.float32)
        for c in range(cols):
            lo, hi = A.indptr[c], A.indptr[c + 1]
            n = min(hi - lo, max_nnz)
            idx[c, :n] = A.indices[lo:lo + n]
            val[c, :n] = A.data[lo:lo + n]
        return idx, val
    indptr, indices, data = _csc_arrays(A)
    idx = np.empty((cols_pad, max_nnz), np.int32)
    val = np.empty((cols_pad, max_nnz), np.float32)
    lib.singlet_csc_to_ell(cols, cols_pad, max_nnz, pad_row,
                           _ptr(indptr, ctypes.c_int64),
                           _ptr(indices, ctypes.c_int32),
                           _ptr(data, ctypes.c_float),
                           _ptr(idx, ctypes.c_int32),
                           _ptr(val, ctypes.c_float))
    return idx, val


def _csc_to_bell_numpy(A: sp.csc_matrix, cols_pad: int, gene_block: int,
                       n_gb: int, width: int
                       ) -> Tuple[np.ndarray, np.ndarray]:
    """The vectorized numpy packer of ``csc_to_bell`` (sorted ``A``)."""
    cols = A.shape[1]
    li = np.full((n_gb, cols_pad, width), -1, np.int32)
    lv = np.zeros((n_gb, cols_pad, width), np.float32)
    if A.nnz:
        nnz_col = np.diff(A.indptr)
        gb_of = A.indices.astype(np.int64) // gene_block
        col_of = np.repeat(np.arange(cols, dtype=np.int64), nnz_col)
        pos = np.arange(A.nnz, dtype=np.int64) - np.repeat(
            A.indptr[:-1].astype(np.int64), nnz_col)
        # rank within the (col, gb) run: runs are contiguous because CSC
        # row indices are sorted within a column
        new_run = np.ones(A.nnz, bool)
        new_run[1:] = (col_of[1:] != col_of[:-1]) | (gb_of[1:] != gb_of[:-1])
        run_id = np.cumsum(new_run) - 1
        rank = pos - pos[new_run][run_id]
        over = int(np.sum(rank >= width))
        if over:
            raise ValueError(
                f"csc_to_bell: plane width {width} under-counts a "
                f"(column, gene-block) run; {over} nonzeros would be dropped")
        li[gb_of, col_of, rank] = (A.indices - gb_of * gene_block).astype(
            np.int32)
        lv[gb_of, col_of, rank] = A.data.astype(np.float32)
    return li, lv


def csc_to_bell(A: sp.csc_matrix, cols_pad: int, gene_block: int,
                n_gb: int, width: int) -> Tuple[np.ndarray, np.ndarray]:
    """CSC -> gb-major blocked-ELL planes, shape (n_gb, cols_pad, width):
    local gene indices (pad -1) and values (pad 0) at one uniform width.
    The native parallel packer; fallback: vectorized numpy, the same planes
    bit for bit. Both raise ValueError if ``width`` under-counts any
    (column, gene-block) run: silent truncation would corrupt the operand.
    ``A`` is never mutated (indices are sorted on a copy)."""
    A = sp.csc_matrix(A)
    if not A.has_sorted_indices:
        A = A.copy()
        A.sort_indices()
    lib = _load()
    if lib is None:
        return _csc_to_bell_numpy(A, cols_pad, gene_block, n_gb, width)
    indptr, indices, data = _csc_arrays(A)
    li = np.empty((n_gb, cols_pad, width), np.int32)
    lv = np.empty((n_gb, cols_pad, width), np.float32)
    _check(lib, lib.singlet_csc_to_bell(
        A.shape[1], cols_pad, gene_block, n_gb, width,
        _ptr(indptr, ctypes.c_int64), _ptr(indices, ctypes.c_int32),
        _ptr(data, ctypes.c_float), _ptr(li, ctypes.c_int32),
        _ptr(lv, ctypes.c_float)), ValueError)
    return li, lv


def _log_normalize(counts: sp.spmatrix, scale_factor: float) -> sp.csc_matrix:
    """Seurat LogNormalize of sparse counts (a copy of the sparse branch of
    ``singlet_tpu.preprocess.log_normalize``): per-cell unit normalization
    times ``scale_factor``, then log1p."""
    m = counts.tocsc().astype(np.float32, copy=True)
    colsums = np.asarray(m.sum(axis=0)).ravel()
    colsums[colsums == 0] = 1.0
    scale = (scale_factor / colsums).astype(np.float32)
    m = m.multiply(sp.csr_matrix(scale[None, :])).tocsc()
    m.data = np.log1p(m.data)
    return m


def log_normalize_inplace(A: sp.csc_matrix, scale_factor: float = 1e4
                          ) -> sp.csc_matrix:
    """Multithreaded LogNormalize of CSC data, on a copy of ``A``
    (fallback: the numpy LogNormalize)."""
    lib = _load()
    if lib is None:
        return _log_normalize(A, scale_factor)
    A = sp.csc_matrix(A, copy=True)
    A.data = np.ascontiguousarray(A.data, np.float32)
    indptr = np.ascontiguousarray(A.indptr, np.int64)
    lib.singlet_log_normalize(A.shape[1], _ptr(indptr, ctypes.c_int64),
                              _ptr(A.data, ctypes.c_float), scale_factor)
    return A


# ---------------------------------------------------------------------------
# SVC1 compressed shards (out-of-core staging, IVCSC analogue)
# ---------------------------------------------------------------------------

def svc_write(path: str, A: sp.csc_matrix,
              value_compress: bool = False) -> None:
    """Write a compressed SVC shard. ``value_compress`` engages the v2
    value-grouped encoding (VCSC analogue,
    reference:inst/include/src/VCSC/VCSC_SparseMatrix.hpp:20-30): each
    distinct value stored once per column, smaller for highly redundant
    values (raw counts, log-normalized counts). Fallback: ``path + ".npz"``
    (numpy's ``savez_compressed``, the JAX package's fallback)."""
    lib = _load()
    A = sp.csc_matrix(A)
    if lib is None:
        np.savez_compressed(path, indptr=A.indptr, indices=A.indices,
                            data=A.data, shape=A.shape)
        return
    indptr, indices, data = _csc_arrays(A)
    fn = lib.singlet_svc_write_v2 if value_compress else lib.singlet_svc_write
    _check(lib, fn(path.encode(), A.shape[0], A.shape[1],
                   _ptr(indptr, ctypes.c_int64),
                   _ptr(indices, ctypes.c_int32),
                   _ptr(data, ctypes.c_float)))


def _svc_header(lib, path: str):
    rows, cols, nnz = ctypes.c_int64(), ctypes.c_int64(), ctypes.c_int64()
    _check(lib, lib.singlet_svc_read_header(
        path.encode(), ctypes.byref(rows), ctypes.byref(cols),
        ctypes.byref(nnz)))
    return rows.value, cols.value, nnz.value


def svc_shape(path: str):
    """(rows, cols, nnz) of an SVC shard from its header: no data read."""
    lib = _load()
    if lib is None:
        M = svc_read(path)
        return M.shape[0], M.shape[1], M.nnz
    return _svc_header(lib, path)


def svc_read(path: str) -> sp.csc_matrix:
    lib = _load()
    if lib is None:
        z = np.load(path if path.endswith(".npz") else path + ".npz")
        return sp.csc_matrix((z["data"], z["indices"], z["indptr"]),
                             shape=tuple(z["shape"]))
    rows, cols, nnz = _svc_header(lib, path)
    indptr = np.zeros(cols + 1, np.int64)
    indices = np.zeros(nnz, np.int32)
    data = np.zeros(nnz, np.float32)
    _check(lib, lib.singlet_svc_read(path.encode(),
                                     _ptr(indptr, ctypes.c_int64),
                                     _ptr(indices, ctypes.c_int32),
                                     _ptr(data, ctypes.c_float)))
    return sp.csc_matrix((data, indices, indptr), shape=(rows, cols))

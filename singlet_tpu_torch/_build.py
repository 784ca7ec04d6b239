"""Build the port's CUDA sources into shared libraries and load them.

Each ``csrc/<name>.cu`` has a plain C interface. At first use it is compiled
with ``nvcc`` for ``sm_90a`` into ``build/singlet_tpu_torch/`` at the root
of the checkout (git-ignored), under a file name that carries a hash of the
source, the local headers it includes and the flags, and loaded with
``ctypes``. A missing ``nvcc`` or a failed
build raises; nothing falls back to the plain PyTorch versions.

Kernels are compiled WITHOUT ``--use_fast_math``: the CD-NNLS clamp term
``x_i / 1e-15`` and its ``tol / k <= 1e-8`` exit depend on IEEE division
and on denormals not being flushed.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import time
from pathlib import Path

PACKAGE_DIR = Path(__file__).resolve().parent
CSRC_DIR = PACKAGE_DIR / "csrc"
BUILD_DIR = PACKAGE_DIR.parent / "build" / "singlet_tpu_torch"

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_LOADED: dict = {}


def find_nvcc() -> str:
    """Path of nvcc: on PATH, else under CUDA_HOME or /usr/local/cuda."""
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    cand = Path(home) / "bin" / "nvcc"
    if cand.is_file():
        return str(cand)
    raise RuntimeError("nvcc not found (PATH, CUDA_HOME, /usr/local/cuda); "
                       "the CUDA kernels are built from source at first use")


_LOCAL_INCLUDE = re.compile(rb'^[ \t]*#[ \t]*include[ \t]*"([^"]+)"', re.M)


def source_digest(src: Path) -> str:
    """sha256 (hex) of a source, of every local header it includes
    (``#include "..."`` beside the file that names it, followed
    recursively) and of the nvcc flags: an edit to any of them gives a new
    library name, so a stale build is never loaded."""
    h = hashlib.sha256()
    seen, todo = set(), [Path(src)]
    while todo:
        path = todo.pop(0).resolve()
        if path in seen:
            continue
        seen.add(path)
        text = path.read_bytes()
        h.update(str(len(text)).encode() + b":" + text)
        todo += [path.parent / m.decode() for m in _LOCAL_INCLUDE.findall(text)
                 if (path.parent / m.decode()).is_file()]
    h.update(" ".join(NVCC_FLAGS).encode())
    return h.hexdigest()


def build(name: str) -> tuple[Path, float, str]:
    """Compile ``csrc/<name>.cu`` unless a library of the same digest
    (``source_digest``) exists. Returns (library path, seconds spent
    compiling, compiler log)."""
    src = CSRC_DIR / f"{name}.cu"
    lib = BUILD_DIR / f"lib{name}_{source_digest(src)[:16]}.so"
    log_path = lib.with_suffix(".log")
    if lib.is_file():
        log = log_path.read_text() if log_path.is_file() else ""
        return lib, 0.0, log
    nvcc = find_nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_name(f"{lib.name}.{os.getpid()}.tmp")
    t0 = time.perf_counter()
    proc = subprocess.run([nvcc, *NVCC_FLAGS, "-o", str(tmp), str(src)],
                          capture_output=True, text=True)
    seconds = time.perf_counter() - t0
    log = proc.stdout + proc.stderr
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(
            f"nvcc failed on {src} (rc {proc.returncode}):\n{log}")
    log_path.write_text(log)
    os.replace(tmp, lib)    # atomic: concurrent builders see whole files only
    return lib, seconds, log


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built on first use."""
    if name not in _LOADED:
        path, _, _ = build(name)
        _LOADED[name] = ctypes.CDLL(str(path))
    return _LOADED[name]

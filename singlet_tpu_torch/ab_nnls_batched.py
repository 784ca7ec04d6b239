"""Time two versions of kernel B2 (``csrc/nnls_cd_batched.cu``) against
each other on one CUDA card, in turns, on the same inputs.

    python3 -m singlet_tpu_torch.ab_nnls_batched OLD.cu NEW.cu

Both sources are compiled with ``_build``'s nvcc flags, started together,
into the git-ignored ``build/``. Per k in ``KS`` the inputs are those of a
masked half-update (per-column Grams ``at`` of 5% masked rows, n=4096,
sweep cap 32, the shape of ``chip_smoke.py``'s B2 rows); each turn times
one version as the median of ``RUNS`` calls by CUDA events, in the order
old, new, new, old repeated ``ROUNDS`` times. The two outputs must be equal bit for bit.
Prints one JSON line per k with every turn's time and the card's name and
power limit.
"""

from __future__ import annotations

import argparse
import ctypes
import hashlib
import json
import statistics
import subprocess
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

KS = (50, 100, 200)
N = 4096
SWEEP_CAP = 32.0
RUNS = 20
ROUNDS = 5


def _compile(src: Path) -> ctypes.CDLL:
    from singlet_tpu_torch import _build

    digest = hashlib.sha256(src.read_bytes()
                            + " ".join(_build.NVCC_FLAGS).encode())
    lib = _build.BUILD_DIR / f"ab_{digest.hexdigest()[:16]}.so"
    if not lib.is_file():
        _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
        subprocess.run([_build.find_nvcc(), *_build.NVCC_FLAGS, "-o",
                        str(lib), str(src)], check=True, capture_output=True)
    return ctypes.CDLL(str(lib))


def _bind(lib):
    from singlet_tpu_torch.ops.nnls_cuda import _ARGTYPES

    fn = lib.nnls_cd_batched
    fn.argtypes = _ARGTYPES
    fn.restype = ctypes.c_int
    return fn


def _inputs(torch, n: int, k: int, seed: int):
    """(at, inv_diag, B, X0, mask): per-column Grams a_full minus the
    packed Gram of each column's 5% masked rows, as a masked half-update
    makes them."""
    from singlet_tpu_torch.ops import linalg

    gen = torch.Generator(device="cuda").manual_seed(seed)
    m_rows = 2 * k
    F = torch.rand((m_rows, k), generator=gen, device="cuda")
    iu = linalg.triu_pairs(k)
    m = torch.rand((n, m_rows), generator=gen, device="cuda") < 0.05
    at = linalg.unpack_sym_from_t(
        linalg.mask_dot_t(linalg.packed_outer_products(F, iu), m, 1), k, iu,
        F.T @ F + 1e-15 * torch.eye(k, device="cuda")).contiguous()
    B = torch.where(m, 0.0, torch.rand((n, m_rows), generator=gen,
                                       device="cuda")) @ F
    X0 = (torch.rand((n, k), generator=gen, device="cuda")
          * (torch.rand((n, k), generator=gen, device="cuda") < 0.5))
    mask = torch.rand(n, generator=gen, device="cuda") >= 0.05
    inv_diag = 1.0 / at.reshape(k * k, n)[:: k + 1]
    return at, inv_diag.contiguous(), B.contiguous(), X0, mask


def main() -> int:
    import torch

    from singlet_tpu_torch.ops.nnls import CD_MAX_SWEEPS

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("old", type=Path)
    ap.add_argument("new", type=Path)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("ab_nnls_batched needs a CUDA device")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    with ThreadPoolExecutor(2) as pool:
        fns = {name: _bind(lib) for name, lib in zip(
            ("old", "new"), pool.map(_compile, (args.old, args.new)))}
    stream = torch.cuda.current_stream().cuda_stream
    for k in KS:
        at, inv_diag, B, X0, mask = _inputs(torch, N, k, seed=k)
        outs = {name: torch.empty_like(B) for name in fns}

        def call(name):
            err = fns[name](at.data_ptr(), inv_diag.data_ptr(), B.data_ptr(),
                            X0.data_ptr(), mask.data_ptr(),
                            outs[name].data_ptr(), N, k, 0.01, 0.001,
                            float(k), SWEEP_CAP, CD_MAX_SWEEPS, stream)
            if err:
                raise RuntimeError(f"nnls_cd_batched ({name}) failed: {err}")

        for name in fns:
            call(name)
        torch.cuda.synchronize()
        if not torch.equal(outs["old"], outs["new"]):
            raise AssertionError(f"k={k}: the two versions differ")
        turns = {name: [] for name in fns}
        for _ in range(ROUNDS):
            for name in ("old", "new", "new", "old"):
                times = []
                for _ in range(RUNS):
                    start = torch.cuda.Event(enable_timing=True)
                    end = torch.cuda.Event(enable_timing=True)
                    start.record()
                    call(name)
                    end.record()
                    torch.cuda.synchronize()
                    times.append(start.elapsed_time(end))
                turns[name].append(statistics.median(times))
        print(json.dumps({
            "k": k, "n": N, "sweep_cap": SWEEP_CAP, "card": card,
            "same_bits": True,
            "old_ms": turns["old"], "new_ms": turns["new"],
            "old_median_ms": statistics.median(turns["old"]),
            "new_median_ms": statistics.median(turns["new"])}), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())

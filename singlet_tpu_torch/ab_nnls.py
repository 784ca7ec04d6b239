"""Time two versions of kernel B1 (``csrc/nnls_cd.cu``) against each other
on one CUDA card, in turns, on the same inputs.

    python3 -m singlet_tpu_torch.ab_nnls OLD.cu [NEW.cu]

OLD.cu is the one-warp-per-column source of commit fb6bcee (``git show
fb6bcee:singlet_tpu_torch/csrc/nnls_cd.cu > build/old_nnls_cd.cu``): its
entries ``nnls_cd_shared`` (k <= 224) and ``nnls_cd_global`` take 1/diag
from the caller and a scalar L1. NEW.cu (default the checkout's
``csrc/nnls_cd.cu``) takes the plan of ``ops/nnls_cuda.py`` ``b1_plan``
through its entry ``nnls_cd``. Both are compiled with ``_build``'s nvcc
flags, started together, into the git-ignored ``build/``.

Shapes (``SHAPES``, n x k at a sweep cap): ``chip_smoke.py``'s phase 2
(8192 x 50, 16384 x 50, 1500 x 10, 4096 x 100) at caps 8 and 100, the
plain 524k ELL step's two calls at cap 8 (524,288 x 100 and 16,384 x 100),
and k = 256 and 300 (2048 columns, cap 8); the inputs are those of
``chip_smoke.py`` ``_nnls_problem`` made on the card (a Gram F^T F, B = G
F, a warm X0 with zeros, 5% of the columns masked out; L1 0.01, L2 0.001).
One more row gives the new source an (n, k) L1 of 0.01 everywhere against
the old source's scalar 0.01 (4096 x 100, cap 8). Each turn times one
version as the median of ``RUNS`` samples by CUDA events, a sample the
mean of ``REPS`` calls launched back to back (so that the harness's own
host work on a call, which differs between the two entries, stays off the
card's clock at the small shapes), in the order old, new, new, old
repeated ``ROUNDS`` times. The two versions' outputs must be
equal bit for bit. Prints one JSON line per row with every turn's time,
the ratio of the medians (new over old) and the card's name and power
limit; at cap 100 also ``lockstep``: over the new plan's warps, the mean of
(the warp's largest sweep count / its columns' mean), the columns' sweep
counts from the plain version on the same inputs (its active columns
only).
"""

from __future__ import annotations

import argparse
import ctypes
import json
import statistics
import subprocess
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

from singlet_tpu_torch.ab_nnls_batched import _compile

RUNS = 10
REPS = 5
ROUNDS = 3
# (n, k, sweep cap, (n, k) L1 on the new side)
SHAPES = ((8192, 50, 8, False), (16384, 50, 8, False), (1500, 10, 8, False),
          (4096, 100, 8, False), (8192, 50, 100, False),
          (16384, 50, 100, False), (1500, 10, 100, False),
          (4096, 100, 100, False), (524288, 100, 8, False),
          (16384, 100, 8, False), (2048, 256, 8, False),
          (2048, 300, 8, False), (4096, 100, 8, True))
L1, L2 = 0.01, 0.001

_VP, _CI, _CF = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
# the old entries: six pointers, n, k, L1, L2, k_div, cap, max_sweeps, stream
_OLD_ARGTYPES = [_VP] * 6 + [_CI, _CI, _CF, _CF, _CF, _CF, _CI, _VP]


def _bind(lib, new: bool):
    """The entries of a built source: the new ``nnls_cd``, or the old
    (``nnls_cd_shared``, ``nnls_cd_global``)."""
    from singlet_tpu_torch.ops.nnls_cuda import ARGTYPES_B1

    if new:
        fn = lib.nnls_cd
        fn.argtypes = ARGTYPES_B1
        fn.restype = _CI
        return fn
    fns = (lib.nnls_cd_shared, lib.nnls_cd_global)
    for fn in fns:
        fn.argtypes = _OLD_ARGTYPES
        fn.restype = _CI
    return fns


def _problem(torch, n: int, k: int, seed: int):
    """(a, B, X0, mask) of ``chip_smoke.py`` ``_nnls_problem``'s geometry,
    made on the card."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    m = max(64, 2 * k)
    F = torch.rand((m, k), generator=gen, device="cuda")
    a = F.T @ F + 1e-15 * torch.eye(k, device="cuda")
    B = torch.rand((n, m), generator=gen, device="cuda") @ F
    X0 = (torch.rand((n, k), generator=gen, device="cuda")
          * (torch.rand((n, k), generator=gen, device="cuda") < 0.5))
    mask = torch.rand(n, generator=gen, device="cuda") >= 0.05
    return a.contiguous(), B.contiguous(), X0, mask


def _turns(torch, call):
    """Per version, the median over RUNS samples of each turn, a sample
    the mean of REPS calls launched back to back (the host's work on a
    call overlaps the previous call on the card, as in a fit), in the
    order old, new, new, old, ROUNDS times."""
    turns = {"old": [], "new": []}
    for _ in range(ROUNDS):
        for name in ("old", "new", "new", "old"):
            times = []
            for _ in range(RUNS):
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                start.record()
                for _ in range(REPS):
                    call(name)
                end.record()
                torch.cuda.synchronize()
                times.append(start.elapsed_time(end) / REPS)
            turns[name].append(statistics.median(times))
    old, new = (statistics.median(turns[v]) for v in ("old", "new"))
    return {"old_ms": turns["old"], "new_ms": turns["new"],
            "old_median_ms": old, "new_median_ms": new, "ratio": new / old}


def _lockstep(torch, sweeps, mask, cols: int) -> float:
    """Mean over the warps of the plan (``cols`` neighbouring columns
    each) of the warp's largest sweep count over its active columns'
    mean."""
    n = sweeps.shape[0]
    pad = -(-n // cols) * cols - n
    s = torch.nn.functional.pad(sweeps.float(), (0, pad)).view(-1, cols)
    m = torch.nn.functional.pad(mask.float(), (0, pad)).view(-1, cols)
    live = m.sum(dim=1)
    keep = live > 0
    mean = (s * m).sum(dim=1)[keep] / live[keep]
    return float((s.max(dim=1).values[keep] / mean).mean())


def main() -> int:
    import torch

    from singlet_tpu_torch import _build
    from singlet_tpu_torch.ops import nnls
    from singlet_tpu_torch.ops.nnls import CD_MAX_SWEEPS
    from singlet_tpu_torch.ops.nnls_cuda import b1_plan

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("old", type=Path)
    ap.add_argument("new", type=Path, nargs="?",
                    default=_build.CSRC_DIR / "nnls_cd.cu")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("ab_nnls needs a CUDA device")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    with ThreadPoolExecutor(2) as pool:
        old_lib, new_lib = pool.map(_compile, (args.old, args.new))
    old_fns, new_fn = _bind(old_lib, False), _bind(new_lib, True)
    stream = torch.cuda.current_stream().cuda_stream

    def check(err, what):
        if err:
            raise RuntimeError(f"{what} failed: {err}")

    for n, k, cap, l1_array in SHAPES:
        a, B, X0, mask = _problem(torch, n, k, seed=n + k)
        plan = b1_plan(n, k)
        inv_diag = 1.0 / torch.diagonal(a)
        old_aT = a.t().contiguous()
        new_aT = None
        if not plan.shared:
            new_aT = torch.zeros((k + 1, 32 * plan.npl), device="cuda")
            new_aT[:k, :k] = a.t()
            new_aT[k] = new_aT[0]
        l1 = torch.full_like(B, L1) if l1_array else None
        outs = {v: torch.empty_like(B) for v in ("old", "new")}
        scalars = (float(k), float(cap), CD_MAX_SWEEPS, stream)

        def call(name):
            X = outs[name]
            if name == "old":
                if k <= 224:
                    check(old_fns[0](a.data_ptr(), inv_diag.data_ptr(),
                                     B.data_ptr(), X0.data_ptr(),
                                     mask.data_ptr(), X.data_ptr(), n, k,
                                     L1, L2, *scalars), "nnls_cd_shared")
                else:
                    check(old_fns[1](old_aT.data_ptr(), inv_diag.data_ptr(),
                                     B.data_ptr(), X0.data_ptr(),
                                     mask.data_ptr(), X.data_ptr(), n, k,
                                     L1, L2, *scalars), "nnls_cd_global")
                return
            check(new_fn(a.data_ptr(),
                         None if new_aT is None else new_aT.data_ptr(),
                         None if l1 is None else l1.data_ptr(),
                         B.data_ptr(), X0.data_ptr(), mask.data_ptr(),
                         X.data_ptr(), n, k, plan.g,
                         0.0 if l1_array else L1, L2, *scalars), "nnls_cd")

        for name in outs:
            outs[name].fill_(float("nan"))
            call(name)
        torch.cuda.synchronize()
        if not torch.equal(outs["old"], outs["new"]):
            bad = int((outs["old"] != outs["new"]).any(dim=1).sum())
            raise AssertionError(f"n={n} k={k} cap={cap} l1_array="
                                 f"{l1_array}: {bad} columns differ")
        row = {"n": n, "k": k, "sweep_cap": cap, "l1_array": l1_array,
               "g": plan.g, "npl": plan.npl, "shared": plan.shared,
               "card": card, "same_bits": True, **_turns(torch, call)}
        if cap == 100:
            _, sweeps = nnls.nnls_batch(a, B, X0, L1=L1, L2=L2,
                                        update_mask=mask,
                                        sweep_cap=float(cap),
                                        return_sweeps=True)
            row["lockstep"] = _lockstep(torch, sweeps, mask, plan.cols)
        print(json.dumps(row), flush=True)
        del a, B, X0, mask, outs, old_aT, new_aT, l1
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())

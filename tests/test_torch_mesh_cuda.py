"""The cell mesh on the card: a world of one over NCCL gives the bits of the
engine with no mesh, and two gloo ranks sharing one card (the one way to
run two ranks on a single GPU: NCCL refuses two ranks on one device) agree
with the world of one at rtol 5e-3, atol 5e-4 (the fit gate of
``chip_smoke.py``), with equal iteration counts and the same W bits on
both ranks.

A CUDA kernel has no CPU mode, so every test here needs a card and skips
without one. On a machine with a card (and without jax, which
``tests/conftest.py`` imports), run:

    python -m pytest --noconftest tests/test_torch_mesh_cuda.py -q

The two ranks run as subprocesses of this file (``--worker``), joined
through a ``FileStore`` as in tests/test_torch_mesh.py.
"""

import os
import sys

import numpy as np
import pytest
import scipy.sparse as sp

from test_torch_mesh import World

pytestmark = pytest.mark.cuda

FIT = dict(rtol=5e-3, atol=5e-4)
K = 8


@pytest.fixture
def cuda():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the engine's kernels have no CPU "
                    "mode")
    return torch.device("cuda")


def _operand():
    A = sp.random(500, 5000, density=0.05, random_state=6, dtype=np.float32,
                  format="csc")
    A.data = np.abs(A.data) + 0.1
    return A


def fits(stt, mesh, device) -> dict:
    """The plain fit, the bits-route ard_fit and the dense mesh engine's
    plain and masked fits on ``mesh`` (None: no mesh)."""
    A = _operand()
    w0 = np.random.default_rng(1).random((500, K)).astype(np.float32)
    eng = stt.ShardedEllEngine(A, mesh=mesh, device=device, cell_block=1024,
                               gene_block=256)
    out = {}
    r = eng.fit(K, tol=0.0, maxit=4, w_init=w0)
    out.update({f"fit_{f}": np.asarray(r[f]) for f in ("w", "d", "h")})
    out["fit_its"] = np.asarray(len(r["tol_trace"]))
    a = eng.ard_fit(K, w_init=w0, maxit=3, tol=0.0)
    out.update({f"ard_{f}": np.asarray(getattr(a, f)) for f in
                ("w", "d", "h", "test_mse", "iter")})
    for masked in (False, True):
        r = stt.sharded_nmf_fit(A.toarray(), K, mesh=mesh, tol=0.0, maxit=3,
                                w_init=w0, masked=masked, device=device)
        key = "dense_masked" if masked else "dense"
        out.update({f"{key}_{f}": np.asarray(r[f]) for f in ("w", "d", "h")})
        out[f"{key}_its"] = np.asarray(len(r["tol_trace"]))
    return out


def test_world_of_one_over_nccl_gives_the_bits_of_no_mesh(cuda):
    import torch.distributed as dist

    import singlet_tpu_torch as stt

    want = fits(stt, None, "cuda")
    mesh = stt.make_mesh()
    try:
        assert dist.get_backend() == "nccl" and mesh.size() == 1
        got = fits(stt, mesh, "cuda")
    finally:
        dist.destroy_process_group()
    for key, v in want.items():
        np.testing.assert_array_equal(got[key], v, err_msg=key)


def test_two_gloo_ranks_on_the_card_match_the_world_of_one(cuda, tmp_path):
    import singlet_tpu_torch as stt

    want = fits(stt, None, "cuda")
    ranks = World(tmp_path, __file__, "fits", 2).results()
    for key, v in want.items():
        if key.endswith("_its") or key.endswith("_iter"):
            for r in ranks:
                np.testing.assert_array_equal(r[key], v, err_msg=key)
        else:
            np.testing.assert_allclose(ranks[0][key], v, **FIT, err_msg=key)
        np.testing.assert_array_equal(ranks[1][key], ranks[0][key],
                                      err_msg=f"rank 1 {key}")


def _worker() -> None:
    """``--worker fits 2 <rank> <dir>``: a gloo rank on cuda:0."""
    import torch.distributed as dist

    import singlet_tpu_torch as stt

    n, rank, out = int(sys.argv[3]), int(sys.argv[4]), sys.argv[5]
    stt.initialize(coordinator_address="file://" + os.path.join(out,
                                                                "store"),
                   num_processes=n, process_id=rank, backend="gloo",
                   device="cuda:0")
    mesh = stt.make_mesh(n, device="cuda:0")
    np.savez(os.path.join(out, f"rank{rank}.npz"),
             **fits(stt, mesh, "cuda:0"))
    dist.destroy_process_group()


if __name__ == "__main__" and sys.argv[1:2] == ["--worker"]:
    _worker()

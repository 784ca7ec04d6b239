"""The ELL engine's hash route (``singlet_tpu_torch/parallel/sharded_ell.py``:
per cell block B3 and B4 with the keep factor hashed, the bf16 mask
products B10 and B11 with the mask hashed, B2 the solves; the hashed f32
test MSE) against the JAX engine's hash route, on the CPU.

On the CPU both engines take their f32 route. The port's is forced onto
its kernel routes by patching its backend test ``_kernel_device``; the
plain versions of B3, B4, B10 and B11 then run. The JAX engine is forced
as in tests/test_torch_sharded_ell_bits.py: the module global ``jax`` of
``singlet_tpu.parallel.sharded_ell`` is replaced by a copy of the
namespace whose ``default_backend`` says "tpu", and the Pallas kernels it
imports at the call are wrapped to run in interpret mode. The NNLS solves
stay on XLA, because ``ops/nnls.py`` checks the real backend. No file of
the JAX package is edited.

Two ways reach the hash route in both engines: ``SINGLET_TPU_MASKGRAM=hash``
(``fit(masked=True)`` and ``ard_fit``), and a checkpointed ``ard_fit`` on
the default mode, whose per-step path packs no mask. The geometry (512
genes x 4096 cells, 5% dense, blocks of 2048 cells and 256 genes) has two
cell blocks, so B11 adds into the carry twice per step, and two gene
blocks. Tolerances are those of tests/test_torch_sharded_ell_bits.py:
rtol 5e-3, atol 5e-4 with equal ``iter`` lists; the bf16 operands of the
two engines round products summed in another order, so the fits agree
within the fit tolerance, not bit for bit.
"""

import functools
import types

import jax
import numpy as np
import pytest
import scipy.sparse as sp
import torch

from singlet_tpu.checkpoint import CheckpointManager as JaxManager
from singlet_tpu.ops import pallas_bell, pallas_maskgram
from singlet_tpu.parallel import sharded_ell as jell
from singlet_tpu.parallel.sharded import make_mesh
from singlet_tpu_torch.checkpoint import CheckpointManager
from singlet_tpu_torch.ops import bell, maskgram
from singlet_tpu_torch.parallel import sharded_ell as tell

FIT = dict(rtol=5e-3, atol=5e-4)
GENES, CELLS, K = 512, 4096, 4
BLOCKS = CELLS // 2048


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One torch intra-op thread in this module: the suite runs one worker
    process per core, and a thread pool per worker oversubscribes them."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def kernel_routes(monkeypatch):
    """Both engines on their kernel routes, on the CPU. Returns the names
    of the JAX hash-route kernels as they are called (or traced)."""
    called = []
    monkeypatch.setattr(tell, "_kernel_device", lambda device: True)
    fake = types.SimpleNamespace(**{name: getattr(jax, name)
                                    for name in dir(jax)
                                    if not name.startswith("__")})
    fake.default_backend = lambda: "tpu"
    monkeypatch.setattr(jell, "jax", fake)
    for mod, names in ((pallas_bell, ("bell_spmm", "bell_spmm_t")),
                       (pallas_maskgram, ("mask_packed_w_t",
                                          "mask_packed_h_t"))):
        for name in names:
            kern = functools.partial(getattr(mod, name), interpret=True)

            def spy(*a, _kern=kern, _name=name, **kw):
                called.append(_name)
                return _kern(*a, **kw)
            monkeypatch.setattr(mod, name, spy)
    return called


def _operand():
    A = sp.random(GENES, CELLS, density=0.05, random_state=6, format="csc",
                  dtype=np.float32)
    A.data = np.abs(A.data) + 0.1
    return A


def _engines(A):
    return (tell.ShardedEllEngine(A, device="cpu", gene_block=256),
            jell.ShardedEllEngine(A, mesh=make_mesh(1), gene_block=256))


def _counts():
    return bell.PLAIN_CALLS, maskgram.PLAIN_CALLS


def _assert_ard_close(got, want):
    assert got.iter == want.iter
    np.testing.assert_allclose(got.test_mse, want.test_mse, rtol=5e-3)
    np.testing.assert_allclose(got.tol, want.tol, rtol=5e-3, atol=1e-5)
    for f in ("w", "h", "d"):
        np.testing.assert_allclose(getattr(got, f), getattr(want, f), **FIT,
                                   err_msg=f)


def test_ard_fit_hash_route_matches_jax(rng, monkeypatch, kernel_routes):
    monkeypatch.setenv("SINGLET_TPU_MASKGRAM", "hash")
    te, je = _engines(_operand())
    w0 = rng.random((GENES, K)).astype(np.float32)
    kw = dict(w_init=w0, mask_seed=3, maxit=3, tol=0.0, L1=0.01,
              trace_test_mse=1, overfit_threshold=1.0)
    b0, m0 = _counts()
    got = te.ard_fit(K, **kw)
    # per step a B3, B4, B10 and B11 per block; the test MSE is f32
    assert _counts() == (b0 + 3 * 2 * BLOCKS, m0 + 3 * 2 * BLOCKS)
    want = je.ard_fit(K, k_bucket=1, **kw)
    assert {"mask_packed_w_t", "mask_packed_h_t"} <= set(kernel_routes)
    assert got.iter == [0, 1, 2]
    _assert_ard_close(got, want)


def test_masked_fit_hash_route_matches_jax(rng, monkeypatch, kernel_routes):
    monkeypatch.setenv("SINGLET_TPU_MASKGRAM", "hash")
    te, je = _engines(_operand())
    w0 = rng.random((GENES, K)).astype(np.float32)
    kw = dict(w_init=w0, tol=1e-5, maxit=3, masked=True, inv_density=20,
              mask_seed=2, L1=(0.02, 0.01))
    m0 = maskgram.PLAIN_CALLS
    got = te.fit(K, **kw)
    assert maskgram.PLAIN_CALLS == m0 + 2 * BLOCKS * len(got["tol_trace"])
    want = je.fit(K, **kw)
    assert {"mask_packed_w_t", "mask_packed_h_t"} <= set(kernel_routes)
    assert len(got["tol_trace"]) == len(want["tol_trace"]) == 3
    np.testing.assert_allclose(got["tol_trace"], want["tol_trace"], **FIT)
    for f in ("w", "h", "d"):
        np.testing.assert_allclose(got[f], want[f], **FIT, err_msg=f)
    np.testing.assert_allclose(got["test_mse"], want["test_mse"], rtol=5e-3)


def test_checkpointed_ard_fit_takes_the_hash_route(rng, tmp_path,
                                                   kernel_routes):
    """On the default (int8) mode a checkpointed ard_fit packs no mask, so
    both engines run the hash route; the port's fit, stopped at 2
    iterations and resumed to 4, matches JAX's uninterrupted one."""
    te, je = _engines(_operand())
    w0 = rng.random((GENES, K)).astype(np.float32)
    kw = dict(w_init=w0, mask_seed=5, tol=0.0, trace_test_mse=1,
              overfit_threshold=1.0)
    b0, m0 = _counts()
    mgr = CheckpointManager(str(tmp_path / "torch"), every=1)
    te.ard_fit(K, maxit=2, checkpoint=mgr, **kw)
    got = te.ard_fit(K, maxit=4, checkpoint=mgr, **kw)
    assert _counts() == (b0 + 4 * 2 * BLOCKS, m0 + 4 * 2 * BLOCKS)
    want = je.ard_fit(K, maxit=4, checkpoint=JaxManager(
        str(tmp_path / "jax"), every=2), **kw)
    assert {"mask_packed_w_t", "mask_packed_h_t"} <= set(kernel_routes)
    assert got.iter == [0, 1, 2, 3]
    _assert_ard_close(got, want)


@pytest.mark.parametrize("fit", ["fit", "ard_fit"])
def test_checkpointed_fits_under_mask8_take_the_hash_route(
        rng, monkeypatch, tmp_path, fit):
    """MASK8 is read on the bits route alone, as in JAX: a checkpointed
    masked fit packs no mask, so under MASK8=1 it still takes the hash
    route (a B3, B4, B10 and B11 per block and step; no B12) and equals the
    same fit without MASK8 bit for bit."""
    from singlet_tpu_torch.ops import maskbits

    monkeypatch.setattr(tell, "_kernel_device", lambda device: True)
    te = tell.ShardedEllEngine(_operand(), device="cpu", gene_block=256)
    w0 = rng.random((GENES, K)).astype(np.float32)
    if fit == "fit":
        kw = dict(w_init=w0, tol=0.0, maxit=2, masked=True, mask_seed=4)
        fields = ("w", "h", "d", "tol_trace", "test_mse")
    else:
        kw = dict(w_init=w0, mask_seed=4, maxit=2, tol=0.0,
                  trace_test_mse=1, overfit_threshold=1.0)
        fields = ("w", "h", "d", "test_mse", "iter", "tol", "score_overfit")

    def run(label):
        return getattr(te, fit)(K, checkpoint=CheckpointManager(
            str(tmp_path / label), every=1), **kw)

    want = run("plain")
    monkeypatch.setenv("SINGLET_TPU_MASK8", "1")
    b0, m0, u0 = bell.PLAIN_CALLS, maskgram.PLAIN_CALLS, maskbits.PLAIN_CALLS
    got = run("mask8")
    assert (bell.PLAIN_CALLS, maskgram.PLAIN_CALLS, maskbits.PLAIN_CALLS) \
        == (b0 + 2 * 2 * BLOCKS, m0 + 2 * 2 * BLOCKS, u0)
    for f in fields:
        x, y = ((got[f], want[f]) if isinstance(got, dict)
                else (getattr(got, f), getattr(want, f)))
        np.testing.assert_array_equal(x, y, err_msg=f)

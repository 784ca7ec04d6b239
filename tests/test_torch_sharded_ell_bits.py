"""The ELL engine's bits route (``singlet_tpu_torch/parallel/sharded_ell.py``:
the test mask packed once per fit, B5/B6 keep factors from its words, the
int8 or bf16 mask products B8/B9 with the grouped carry flush, the fused
test MSE B7) against the JAX engine's bits route, on the CPU; and the same
route under ``SINGLET_TPU_MASK8=1``, where per group of blocks B12 unpacks
the words into a dense int8 mask that B13 and B14 read in place of B8 and
B9.

On the CPU both engines take their f32 route. The port's is forced to the
bits route by patching its backend test ``_kernel_device``; the plain
versions of B5-B9 then run. The JAX engine is forced likewise: the module
global ``jax`` of ``singlet_tpu.parallel.sharded_ell`` is replaced by a
copy of the namespace whose ``default_backend`` says "tpu", and the Pallas
kernels it imports at the call are wrapped to run in interpret mode. The
NNLS solves stay on XLA, because ``ops/nnls.py`` checks the real backend.
No file of the JAX package is edited.

The geometry (1024 genes x 4096 cells, 5% dense, blocks of 2048 cells and
512 genes) has two cell blocks, so one group of F = 2 blocks flushes with
two quantization groups, and two gene blocks, so the JAX B9 takes gene
slabs (ng = 2). Tolerances are those of tests/test_torch_sharded_ell.py:
``ard_fit`` as ``test_engine_ard_fit_matches_jax`` with equal ``iter``
lists, the masked ``fit`` at rtol 5e-3, atol 5e-4. The int8 quantization
of the two engines starts from products summed in another order, so an
element may round to the neighbouring level: the fits agree within the
fit tolerance, not bit for bit.
"""

import functools
import types

import jax
import numpy as np
import pytest
import scipy.sparse as sp
import torch

from singlet_tpu.ops import maskbits as jmaskbits
from singlet_tpu.ops import pallas_bell, pallas_maskgram
from singlet_tpu.parallel import sharded_ell as jell
from singlet_tpu.parallel.sharded import make_mesh
from singlet_tpu_torch.ops import bell, maskbits, maskgram
from singlet_tpu_torch.parallel import sharded_ell as tell

FIT = dict(rtol=5e-3, atol=5e-4)
GENES, CELLS, K = 1024, 4096, 5


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One torch intra-op thread in this module: the suite runs one worker
    process per core, and a thread pool per worker oversubscribes them."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def bits_route(monkeypatch):
    """Both engines on their bits route, on the CPU."""
    monkeypatch.setattr(tell, "_kernel_device", lambda device: True)
    fake = types.SimpleNamespace(**{name: getattr(jax, name)
                                    for name in dir(jax)
                                    if not name.startswith("__")})
    fake.default_backend = lambda: "tpu"
    monkeypatch.setattr(jell, "jax", fake)
    for mod, names in ((pallas_bell, ("bell_spmm", "bell_spmm_t",
                                      "bell_spmm_bits", "bell_spmm_t_bits",
                                      "bell_mse_bits")),
                       (pallas_maskgram, ("mask_packed_w_t_bits",
                                          "mask_packed_h_t_bits",
                                          "mask_packed_w_t_m8",
                                          "mask_packed_h_t_m8")),
                       (jmaskbits, ("unpack_mask_bits",))):
        for name in names:
            monkeypatch.setattr(mod, name, functools.partial(
                getattr(mod, name), interpret=True))


def _operand():
    A = sp.random(GENES, CELLS, density=0.05, random_state=4, format="csc",
                  dtype=np.float32)
    A.data = np.abs(A.data) + 0.1
    return A


def _counts():
    return bell.PLAIN_CALLS, maskgram.PLAIN_CALLS, maskbits.PLAIN_CALLS


@pytest.mark.parametrize("mode", ["int8", "bf16"])
def test_ard_fit_bits_route_matches_jax(rng, monkeypatch, bits_route, mode):
    monkeypatch.setenv("SINGLET_TPU_MASKGRAM", mode)
    A = _operand()
    w0 = rng.random((GENES, K)).astype(np.float32)
    kw = dict(w_init=w0, mask_seed=3, maxit=4, tol=0.0, L1=0.01,
              trace_test_mse=1, overfit_threshold=1.0)
    te = tell.ShardedEllEngine(A, device="cpu")
    b0, m0, u0 = _counts()
    got = te.ard_fit(K, **kw)
    # per iteration 2 blocks of B5, B6, B8 (bell and maskgram plain calls),
    # one B9 flush and one B7 per traced test MSE; the pair operands of the
    # 2 blocks and of W (maskgram plain calls)
    assert _counts() == (b0 + 4 * (2 * 2 + 1), m0 + 4 * (2 + 1 + 3), u0)
    want = jell.ShardedEllEngine(A, mesh=make_mesh(1)).ard_fit(
        K, k_bucket=1, **kw)
    assert got.iter == want.iter == [0, 1, 2, 3]
    np.testing.assert_allclose(got.test_mse, want.test_mse, rtol=5e-3)
    np.testing.assert_allclose(got.tol, want.tol, rtol=5e-3, atol=1e-5)
    np.testing.assert_allclose(got.score_overfit, want.score_overfit,
                               rtol=5e-2, atol=1e-4)
    for f in ("w", "h", "d"):
        np.testing.assert_allclose(getattr(got, f), getattr(want, f), **FIT,
                                   err_msg=f)


@pytest.mark.parametrize("mode", ["int8", "bf16"])
def test_ard_fit_mask8_route_matches_jax(rng, monkeypatch, bits_route,
                                         mode):
    """MASK8 on both engines' bits route: per step one B12 unpack and one
    B14 flush per group (one group of F = 2 blocks here), a B5, B13 and B6
    per block, no B8 or B9."""
    monkeypatch.setenv("SINGLET_TPU_MASKGRAM", mode)
    monkeypatch.setenv("SINGLET_TPU_MASK8", "1")
    A = _operand()
    w0 = rng.random((GENES, K)).astype(np.float32)
    kw = dict(w_init=w0, mask_seed=3, maxit=4, tol=0.0, L1=0.01,
              trace_test_mse=1, overfit_threshold=1.0)
    te = tell.ShardedEllEngine(A, device="cpu")
    b0, m0, u0 = _counts()
    got = te.ard_fit(K, **kw)
    # maskgram: per step 2 B13 and a B14, and the 3 pair operands
    assert _counts() == (b0 + 4 * (2 * 2 + 1), m0 + 4 * (2 + 1 + 3), u0 + 4)
    called = []
    for mod, name in ((jmaskbits, "unpack_mask_bits"),
                      (pallas_maskgram, "mask_packed_w_t_m8"),
                      (pallas_maskgram, "mask_packed_h_t_m8")):
        kern = getattr(mod, name)

        def spy(*a, _kern=kern, _name=name, **k):
            called.append(_name)
            return _kern(*a, **k)
        monkeypatch.setattr(mod, name, spy)
    want = jell.ShardedEllEngine(A, mesh=make_mesh(1)).ard_fit(
        K, k_bucket=1, **kw)
    assert {"unpack_mask_bits", "mask_packed_w_t_m8",
            "mask_packed_h_t_m8"} <= set(called)
    assert got.iter == want.iter == [0, 1, 2, 3]
    np.testing.assert_allclose(got.test_mse, want.test_mse, rtol=5e-3)
    np.testing.assert_allclose(got.tol, want.tol, rtol=5e-3, atol=1e-5)
    np.testing.assert_allclose(got.score_overfit, want.score_overfit,
                               rtol=5e-2, atol=1e-4)
    for f in ("w", "h", "d"):
        np.testing.assert_allclose(getattr(got, f), getattr(want, f), **FIT,
                                   err_msg=f)


def test_mask8_route_equals_bits_route(rng, monkeypatch):
    """On int8 the port's MASK8 route gives the bits of its bits route: B13
    and B14 sum the same exact integers as B8 and B9."""
    monkeypatch.setattr(tell, "_kernel_device", lambda device: True)
    A = _operand()
    w0 = rng.random((GENES, K)).astype(np.float32)
    kw = dict(w_init=w0, mask_seed=3, maxit=3, tol=0.0, trace_test_mse=1,
              overfit_threshold=1.0)
    te = tell.ShardedEllEngine(A, device="cpu")
    bits = te.ard_fit(K, **kw)
    monkeypatch.setenv("SINGLET_TPU_MASK8", "1")
    u0 = maskbits.PLAIN_CALLS
    m8 = te.ard_fit(K, **kw)
    assert maskbits.PLAIN_CALLS == u0 + 3
    for f in ("w", "h", "d", "test_mse", "iter", "tol", "score_overfit"):
        np.testing.assert_array_equal(getattr(m8, f), getattr(bits, f),
                                      err_msg=f)


@pytest.mark.parametrize("mode", ["int8", "bf16"])
def test_masked_fit_bits_route_matches_jax(rng, monkeypatch, bits_route,
                                           mode):
    monkeypatch.setenv("SINGLET_TPU_MASKGRAM", mode)
    A = _operand()
    w0 = rng.random((GENES, K)).astype(np.float32)
    kw = dict(w_init=w0, tol=1e-5, maxit=3, masked=True, inv_density=20,
              mask_seed=2, L1=(0.02, 0.01))
    got = tell.ShardedEllEngine(A, device="cpu").fit(K, **kw)
    want = jell.ShardedEllEngine(A, mesh=make_mesh(1)).fit(K, **kw)
    assert len(got["tol_trace"]) == len(want["tol_trace"])
    np.testing.assert_allclose(got["tol_trace"], want["tol_trace"], **FIT)
    for f in ("w", "h", "d"):
        np.testing.assert_allclose(got[f], want[f], **FIT, err_msg=f)
    np.testing.assert_allclose(got["test_mse"], want["test_mse"], rtol=5e-3)


def test_bits_route_close_to_f32_route(rng, monkeypatch):
    """The port's bits route and f32 route from one W0: int8 and bf16
    products move the test-MSE trace little."""
    A = _operand()
    w0 = rng.random((GENES, K)).astype(np.float32)
    kw = dict(w_init=w0, mask_seed=3, maxit=2, tol=0.0, trace_test_mse=1,
              overfit_threshold=1.0)
    te = tell.ShardedEllEngine(A, device="cpu")
    f32 = te.ard_fit(K, **kw)
    monkeypatch.setattr(tell, "_kernel_device", lambda device: True)
    for mode in ("int8", "bf16"):
        monkeypatch.setenv("SINGLET_TPU_MASKGRAM", mode)
        got = te.ard_fit(K, **kw)
        assert got.iter == f32.iter
        np.testing.assert_allclose(got.test_mse, f32.test_mse, rtol=1e-3)


def test_route_selection(monkeypatch):
    """The f32 route on the CPU, under MASKGRAM=xla and under a mask
    precision other than the default; the bits route or the hash route
    otherwise on a kernel device, as MASKGRAM says. The prebuilt int8 mask
    (MASK8) is no route of its own: the engine reads it on the bits route
    alone, so a build under MASK8 still takes the bits route."""
    cpu, cuda = torch.device("cpu"), torch.device("cuda")
    assert tell._masked_route(cpu, "int8", "default") == "xla"
    assert tell._masked_route(cpu, "hash", "default") == "xla"
    assert tell._masked_route(cuda, "int8", "default") == "int8"
    assert tell._masked_route(cuda, "bf16", "default") == "bf16"
    assert tell._masked_route(cuda, "xla", "default") == "xla"
    assert tell._masked_route(cuda, "int8", "highest") == "xla"
    assert tell._masked_route(cuda, "int8", "high") == "xla"
    assert tell._masked_route(cuda, "hash", "default") == "hash"
    assert tell._masked_route(cuda, "hash", "highest") == "xla"
    monkeypatch.setattr(tell, "_kernel_device", lambda device: True)
    monkeypatch.setenv("SINGLET_TPU_MASK8", "1")
    data = tell.shard_ell_data(sp.random(64, 300, density=0.2,
                                         random_state=1, format="csc",
                                         dtype=np.float32), "cpu", 256, 32)
    assert tell._build_local_fns(data, 8)["use_bits"]()
    monkeypatch.setenv("SINGLET_TPU_MASK_MM_PRECISION", "exact")
    from singlet_tpu_torch.ops.linalg import mask_mm_precision
    with pytest.raises(ValueError, match="MASK_MM_PRECISION"):
        mask_mm_precision()


@pytest.mark.parametrize("env", [("SINGLET_TPU_MASKGRAM", "hash"),
                                 ("SINGLET_TPU_MASK8", "1")])
def test_unported_routes_raise(rng, monkeypatch, env):
    """The routes once left unported now run: MASK8 the bits route with
    B12, B13 and B14 (per step one B12 and one B14 for the one group of 2
    blocks, a B13 per block), MASKGRAM=hash the hash route's B10/B11 (their
    plain versions here)."""
    monkeypatch.setattr(tell, "_kernel_device", lambda device: True)
    monkeypatch.setenv(*env)
    A = sp.random(64, 300, density=0.2, random_state=1, format="csc",
                  dtype=np.float32)
    te = tell.ShardedEllEngine(A, device="cpu", cell_block=256,
                               gene_block=32)
    if env[0] == "SINGLET_TPU_MASK8":
        m0, u0 = maskgram.PLAIN_CALLS, maskbits.PLAIN_CALLS
        r = te.ard_fit(3, maxit=2, tol=0.0, overfit_threshold=1.0)
        assert r.iter == [0, 1] and np.isfinite(r.test_mse).all()
        f = te.fit(3, maxit=2, tol=0.0, masked=True)
        assert len(f["tol_trace"]) == 2 and np.isfinite(f["test_mse"])
        # per step 2 B13, a B14 and 3 pair operands (2 blocks and W)
        assert maskgram.PLAIN_CALLS == m0 + 2 * 2 * (2 + 1 + 3)
        assert maskbits.PLAIN_CALLS == u0 + 2 * 2
    else:
        # 2 cell blocks of 256: per step a B10 and a B11 per block
        m0 = maskgram.PLAIN_CALLS
        r = te.ard_fit(3, maxit=2, tol=0.0, overfit_threshold=1.0)
        assert r.iter == [0, 1] and np.isfinite(r.test_mse).all()
        f = te.fit(3, maxit=2, tol=0.0, masked=True)
        assert len(f["tol_trace"]) == 2 and np.isfinite(f["test_mse"])
        assert maskgram.PLAIN_CALLS == m0 + 2 * (2 * 2 * 2)
    # the plain fit takes no masked route
    assert len(te.fit(3, maxit=2, tol=0.0)["tol_trace"]) == 2


def test_masked_step_without_bits_raises(rng, monkeypatch):
    """A bits-route step given no packed mask is the JAX engine's hash
    route (B10/B11): it runs, and gives what MASKGRAM=hash gives."""
    monkeypatch.setattr(tell, "_kernel_device", lambda device: True)
    A = sp.random(64, 300, density=0.2, random_state=1, format="csc",
                  dtype=np.float32)
    data = tell.shard_ell_data(A, "cpu", 256, 32)
    W = torch.as_tensor(rng.random((data.genes_pad, 3)).astype(np.float32))
    H = torch.zeros((data.cells_pad, 3))
    from singlet_tpu_torch.ops.rngmask import seed_pair
    m0 = maskgram.PLAIN_CALLS
    got = tell._build_local_fns(data, 8)["masked"](
        W, H, seed_pair(1), 0.0, 0.0, 0.0, 0.0, 3)
    assert maskgram.PLAIN_CALLS == m0 + 2 * 2      # B10 + B11 per block
    monkeypatch.setenv("SINGLET_TPU_MASKGRAM", "hash")
    want = tell._build_local_fns(data, 8)["masked"](
        W, H, seed_pair(1), 0.0, 0.0, 0.0, 0.0, 3)
    for g, w in zip(got, want):
        assert torch.equal(g, w)

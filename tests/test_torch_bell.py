"""The plain versions of kernels B3 and B4 (``singlet_tpu_torch/ops/bell.py``)
against the JAX package's ``bell_spmm`` / ``bell_spmm_t`` in interpret mode
and against its XLA tile formulation (``_make_spmm_fns``), on the CPU, on
the same numpy planes.

Geometries are those of tests/test_pallas_bell.py, and so is the tolerance,
rtol=1e-5 and atol=1e-5: the three compute the same float32 products and
differ only in the order of the sums. The tile builders and the synthetic
large-scale operand are compared exactly.
"""

import os
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp
import torch

from singlet_tpu.ops.pallas_bell import bell_spmm as jax_bell_spmm
from singlet_tpu.ops.pallas_bell import bell_spmm_t as jax_bell_spmm_t
from singlet_tpu.ops.rngmask import seed_pair as jax_seed_pair
from singlet_tpu.parallel import sharded_ell as jell
from singlet_tpu_torch.ops import bell
from singlet_tpu_torch.ops.rngmask import seed_pair
from singlet_tpu_torch.parallel import sharded_ell as tell

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
KERNEL = dict(rtol=1e-5, atol=1e-5)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One torch intra-op thread in this module: the suite runs one worker
    process per core, and a thread pool per worker oversubscribes them
    (the plain versions here are many small ops)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _planes(genes, cells, gene_block, density=0.2, seed=3, empty_cols=()):
    A = sp.random(genes, cells, density=density, random_state=seed,
                  dtype=np.float32, format="csc")
    A.data = np.abs(A.data) + 0.1
    A = A.tolil()
    for c in empty_cols:
        A[:, c] = 0
    A = sp.csc_matrix(A)
    A.eliminate_zeros()
    n_gb = genes // gene_block
    width = tell.bell_width(tell.bell_widths(A, n_gb, gene_block))
    li, lv = tell.csc_to_bell(A, cells, gene_block, n_gb, width)
    return (A, tell.planes_to_device_layout(li),
            tell.planes_to_device_layout(lv), n_gb)


# (genes, cells, gene_block, k, seed, inv_density, cell offset): the
# geometries of tests/test_pallas_bell.py, with its global-id offset case
GEOMETRIES = {
    "b": (96, 48, 32, 7, 11, 5, 0),
    "bw": (96, 48, 32, 6, 23, 4, 0),
    "offset": (64, 32, 32, 3, 7, 6, 1000),
}


def _jax_fns(gene_block, n_gb, inv_density):
    return jell._make_spmm_fns(gene_block, n_gb, inv_density)


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("geom", sorted(GEOMETRIES))
def test_bell_spmm_plain_matches_jax(rng, geom, masked):
    genes, cells, gb, k, seed, inv, off = GEOMETRIES[geom]
    A, li, lv, n_gb = _planes(genes, cells, gb)
    W = rng.random((genes, k)).astype(np.float32)
    ids = jnp.arange(off, off + cells, dtype=jnp.int32)
    got = bell.bell_spmm_plain(
        torch.as_tensor(li), torch.as_tensor(lv), torch.as_tensor(W),
        seed_pair(seed) if masked else None, off, gene_block=gb,
        inv_density=inv).numpy()
    jkern = jax_bell_spmm(jnp.asarray(li), jnp.asarray(lv), jnp.asarray(W),
                          jax_seed_pair(seed), ids, gene_block=gb,
                          inv_density=inv, masked=masked, interpret=True)
    spmm_b, _ = _jax_fns(gb, n_gb, inv)
    jxla = spmm_b(jnp.asarray(li), jnp.asarray(lv), jnp.asarray(W),
                  **(dict(seed=jax_seed_pair(seed), ids=ids) if masked
                     else {}))
    np.testing.assert_allclose(got, np.asarray(jkern), **KERNEL)
    np.testing.assert_allclose(got, np.asarray(jxla), **KERNEL)
    if not masked:
        np.testing.assert_allclose(got, A.T @ W, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("geom", sorted(GEOMETRIES))
def test_bell_spmm_t_plain_matches_jax(rng, geom, masked):
    genes, cells, gb, k, seed, inv, off = GEOMETRIES[geom]
    A, li, lv, n_gb = _planes(genes, cells, gb)
    H = rng.random((cells, k)).astype(np.float32)
    ids = jnp.arange(off, off + cells, dtype=jnp.int32)
    got = bell.bell_spmm_t_plain(
        torch.as_tensor(li), torch.as_tensor(lv), torch.as_tensor(H),
        seed_pair(seed) if masked else None, off, gene_block=gb, n_gb=n_gb,
        inv_density=inv).numpy()
    jkern = jax_bell_spmm_t(jnp.asarray(li), jnp.asarray(lv),
                            jnp.asarray(H), jax_seed_pair(seed), ids,
                            gene_block=gb, n_gb=n_gb, inv_density=inv,
                            masked=masked, interpret=True)
    _, spmm_bw = _jax_fns(gb, n_gb, inv)
    jxla = spmm_bw(jnp.asarray(li), jnp.asarray(lv), jnp.asarray(H),
                   **(dict(seed=jax_seed_pair(seed), ids=ids) if masked
                      else {}))
    np.testing.assert_allclose(got, np.asarray(jkern), **KERNEL)
    np.testing.assert_allclose(got, np.asarray(jxla), **KERNEL)
    if not masked:
        np.testing.assert_allclose(got, A @ H, rtol=1e-4, atol=1e-4)


def _wide_planes():
    """Planes of width 136 > 128: cell 3 holds 130 nonzeros in gene block
    1, the one-shot branch of ``_bell_tile``."""
    genes, cells, gb = 512, 40, 256
    A = sp.random(genes, cells, density=0.05, random_state=5,
                  dtype=np.float32, format="lil")
    A[256:386, 3] = 1.5
    A = sp.csc_matrix(A)
    n_gb = genes // gb
    width = tell.bell_width(tell.bell_widths(A, n_gb, gb))
    assert width == 136
    li, lv = tell.csc_to_bell(A, cells, gb, n_gb, width)
    return (A, tell.planes_to_device_layout(li),
            tell.planes_to_device_layout(lv), gb, n_gb, width)


@pytest.mark.parametrize("width_kind", ["unrolled", "one_shot"])
def test_bell_tile_matches_jax_exactly(width_kind):
    if width_kind == "one_shot":
        A, li, lv, gb, n_gb, width = _wide_planes()
    else:
        A, li, lv, n_gb = _planes(96, 48, 32)
        gb, width = 32, li.shape[0] // n_gb
    for g in range(n_gb):
        sl = slice(g * width, (g + 1) * width)
        got = bell._bell_tile(torch.as_tensor(li[sl]), torch.as_tensor(lv[sl]),
                              gb).numpy()
        want = np.asarray(jell._bell_tile(jnp.asarray(li[sl]),
                                          jnp.asarray(lv[sl]), gb))
        np.testing.assert_array_equal(got, want)
        np.testing.assert_array_equal(
            got, A[g * gb:(g + 1) * gb].T.toarray())


@pytest.mark.parametrize("masked", [False, True])
def test_wide_planes_match_jax(rng, masked):
    A, li, lv, gb, n_gb, _ = _wide_planes()
    k, inv = 5, 4
    W = rng.random((A.shape[0], k)).astype(np.float32)
    H = rng.random((A.shape[1], k)).astype(np.float32)
    seed = seed_pair(8) if masked else None
    jkw = dict(seed=jax_seed_pair(8),
               ids=jnp.arange(A.shape[1])) if masked else {}
    spmm_b, spmm_bw = _jax_fns(gb, n_gb, inv)
    tli, tlv = torch.as_tensor(li), torch.as_tensor(lv)
    np.testing.assert_allclose(
        bell.bell_spmm_plain(tli, tlv, torch.as_tensor(W), seed,
                             gene_block=gb, inv_density=inv).numpy(),
        np.asarray(spmm_b(jnp.asarray(li), jnp.asarray(lv), jnp.asarray(W),
                          **jkw)), **KERNEL)
    np.testing.assert_allclose(
        bell.bell_spmm_t_plain(tli, tlv, torch.as_tensor(H), seed,
                               gene_block=gb, n_gb=n_gb,
                               inv_density=inv).numpy(),
        np.asarray(spmm_bw(jnp.asarray(li), jnp.asarray(lv), jnp.asarray(H),
                           **jkw)), **KERNEL)


def test_pad_only_and_empty_cells(rng):
    """Empty columns are all-pad cells: their B rows are zero and they add
    nothing to Bw; an all-empty operand gives zeros."""
    A, li, lv, n_gb = _planes(64, 40, 32, empty_cols=(0, 7, 39))
    assert (li[:, [0, 7, 39]] == -1).all() and (lv[:, [0, 7, 39]] == 0).all()
    W = torch.as_tensor(rng.random((64, 4)).astype(np.float32))
    H = torch.as_tensor(rng.random((40, 4)).astype(np.float32))
    tli, tlv = torch.as_tensor(li), torch.as_tensor(lv)
    for seed in (None, seed_pair(3)):
        B = bell.bell_spmm_plain(tli, tlv, W, seed, gene_block=32)
        assert (B[[0, 7, 39]] == 0).all()
        H0 = H.clone()
        H0[[0, 7, 39]] = 1e6
        np.testing.assert_allclose(
            bell.bell_spmm_t_plain(tli, tlv, H0, seed, gene_block=32,
                                   n_gb=n_gb).numpy(),
            bell.bell_spmm_t_plain(tli, tlv, H, seed, gene_block=32,
                                   n_gb=n_gb).numpy(), **KERNEL)
    empty = torch.full((n_gb * 8, 16), -1, dtype=torch.int32)
    zeros = torch.zeros((n_gb * 8, 16))
    assert (bell.bell_spmm_plain(empty, zeros, W, gene_block=32) == 0).all()
    assert (bell.bell_spmm_t_plain(empty, zeros, H[:16], gene_block=32,
                                   n_gb=n_gb) == 0).all()


def test_dispatchers_take_plain_versions_on_cpu(rng):
    from singlet_tpu_torch.ops import bell_cuda

    _, li, lv, n_gb = _planes(64, 24, 32)
    W = torch.as_tensor(rng.random((64, 3)).astype(np.float32))
    launches = (bell_cuda.LAUNCHES_SPMM, bell_cuda.LAUNCHES_SPMM_T)
    plain = bell.PLAIN_CALLS
    B = bell.bell_spmm(torch.as_tensor(li), torch.as_tensor(lv), W,
                       gene_block=32)
    bell_cuda.bell_spmm_t_cuda(torch.as_tensor(li), torch.as_tensor(lv), B,
                               gene_block=32, n_gb=n_gb)
    assert (bell_cuda.LAUNCHES_SPMM, bell_cuda.LAUNCHES_SPMM_T) == launches
    assert bell.PLAIN_CALLS == plain + 2


def test_densify_planes_is_the_operand():
    A, li, lv, n_gb = _planes(96, 48, 32)
    dense = bell.densify_planes(torch.as_tensor(li), torch.as_tensor(lv), 32,
                                n_gb)
    np.testing.assert_array_equal(dense.numpy(), A.T.toarray())


@pytest.mark.parametrize("genes,cells,nnz,gene_block",
                         [(32, 96, 8, 8), (1024, 300, 100, 512),
                          (256, 64, 40, 64)])
def test_synth_bell_planes_twin_matches_numpy(genes, cells, nnz, gene_block):
    """chip_smoke.py's torch twin of benchmarks/largescale.py's closed-form
    operand gives the same planes, bit for bit."""
    sys.path.insert(0, ROOT)
    from benchmarks.largescale import synth_bell_planes
    from chip_smoke import synth_bell_planes_torch

    li, lv, width = synth_bell_planes(genes, cells, nnz, gene_block, xp=np)
    tli, tlv, twidth = synth_bell_planes_torch(genes, cells, nnz,
                                               gene_block, device="cpu",
                                               chunk=50)
    assert twidth == width
    np.testing.assert_array_equal(tli.numpy(), li)
    np.testing.assert_array_equal(tlv.numpy(), lv)

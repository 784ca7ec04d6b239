"""The port's native IO library (``singlet_tpu_torch/native``) against its
numpy fallbacks and the JAX package's ``singlet_tpu/native`` on the CPU:
the C++ blocked-ELL packer bit for bit against both numpy packers, the
under-width error and the unmutated input, SVC v1 and v2 shards round
trip and cross between the packages (and so do the ``.npz`` fallbacks),
``read_mtx`` on ``.mtx`` and ``.mtx.gz`` against ``scipy.io`` (rtol 1e-6,
as tests/test_native.py), and the library's name covering the flags and
the host's target."""

import gzip
import os

import numpy as np
import pytest
import scipy.io
import scipy.sparse as sp

from singlet_tpu import native as jnative
from singlet_tpu_torch import native as tnative
from singlet_tpu_torch.parallel import sharded_ell as tell
from test_torch_sharded_ell import _odd_matrices, _sparse


@pytest.fixture(scope="module")
def libs():
    """Both packages' libraries, built here with g++ and zlib."""
    if not (tnative.available() and jnative.available()):
        pytest.fail("the native libraries did not build (g++, zlib.h)")
    return True


def _no_lib(monkeypatch, *mods):
    """Force the numpy / scipy / .npz fallbacks of ``mods``."""
    for mod in mods:
        monkeypatch.setattr(mod, "_load", lambda: None)


@pytest.mark.parametrize("name", sorted(_odd_matrices()))
def test_csc_to_bell_native_matches_numpy_and_jax(libs, name, monkeypatch):
    A = _odd_matrices()[name]
    n_gb, gb = 4, 16
    width = tell.bell_width(tell.bell_widths(A, n_gb, gb))
    native_planes = tnative.csc_to_bell(A, A.shape[1] + 5, gb, n_gb, width)
    _no_lib(monkeypatch, tnative, jnative)
    numpy_planes = tnative.csc_to_bell(A, A.shape[1] + 5, gb, n_gb, width)
    jax_planes = jnative.csc_to_bell(A, A.shape[1] + 5, gb, n_gb, width)
    for got, fallback, jax in zip(native_planes, numpy_planes, jax_planes):
        assert got.dtype == fallback.dtype == jax.dtype
        np.testing.assert_array_equal(got, fallback)
        np.testing.assert_array_equal(got, jax)


@pytest.mark.parametrize("fallback", [False, True])
def test_csc_to_bell_underwidth_and_input(libs, fallback, monkeypatch):
    """Under-width fails loudly on both paths; unsorted input is packed
    from a copy and left as it was."""
    if fallback:
        _no_lib(monkeypatch, tnative)
    A = sp.csc_matrix(np.ones((16, 4), np.float32))  # 16 nnz per (col, gb)
    with pytest.raises(ValueError, match="under-counts"):
        tnative.csc_to_bell(A, 8, 16, 1, 8)
    B = sp.csc_matrix((np.array([1.0, 2.0, 3.0], np.float32),
                       np.array([5, 2, 9], np.int32),
                       np.array([0, 3, 3], np.int64)), shape=(16, 2))
    B.has_sorted_indices = False
    before = (B.indices.copy(), B.data.copy())
    li, lv = tnative.csc_to_bell(B, 2, 16, 1, 8)
    np.testing.assert_array_equal(B.indices, before[0])
    np.testing.assert_array_equal(B.data, before[1])
    np.testing.assert_array_equal(li[0, 0, :3], [2, 5, 9])
    np.testing.assert_array_equal(lv[0, 0, :3], [2.0, 1.0, 3.0])


def _counts(genes=300, cells=120, seed=7):
    A = sp.random(genes, cells, density=0.2, random_state=seed,
                  format="csc", dtype=np.float32)
    A.data = np.ceil(A.data * 4).astype(np.float32)     # values in {1..4}
    return A


@pytest.mark.parametrize("value_compress", [False, True])
def test_svc_round_trip(libs, tmp_path, value_compress):
    A = _counts()
    path = str(tmp_path / "shard.svc")
    tnative.svc_write(path, A, value_compress=value_compress)
    B = tnative.svc_read(path)
    assert B.dtype == np.float32
    np.testing.assert_array_equal(B.toarray(), A.toarray())
    assert tnative.svc_shape(path) == (A.shape[0], A.shape[1], A.nnz)
    assert os.path.getsize(path) < A.nnz * 8 + (A.shape[1] + 1) * 8


def test_svc_v2_is_smaller_for_redundant_values(libs, tmp_path):
    A = _counts()
    p1, p2 = str(tmp_path / "v1.svc"), str(tmp_path / "v2.svc")
    tnative.svc_write(p1, A)
    tnative.svc_write(p2, A, value_compress=True)
    assert os.path.getsize(p2) < os.path.getsize(p1)


@pytest.mark.parametrize("value_compress", [False, True])
@pytest.mark.parametrize("writer", ["jax", "port"])
def test_svc_shards_cross_packages(libs, tmp_path, writer, value_compress):
    """A shard written by one package reads back exactly in the other, the
    same bytes either way."""
    A = _counts(seed=3)
    src, dst = (jnative, tnative) if writer == "jax" else (tnative, jnative)
    path = str(tmp_path / "x.svc")
    src.svc_write(path, A, value_compress=value_compress)
    B = dst.svc_read(path)
    np.testing.assert_array_equal(B.toarray(), A.toarray())
    assert dst.svc_shape(path) == (A.shape[0], A.shape[1], A.nnz)
    other = str(tmp_path / "y.svc")
    dst.svc_write(other, A, value_compress=value_compress)
    with open(path, "rb") as f, open(other, "rb") as g:
        assert f.read() == g.read()


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_npz_fallback_shards_cross_packages(tmp_path, writer, monkeypatch):
    """Without the library both packages write ``path + ".npz"`` and read
    each other's."""
    _no_lib(monkeypatch, tnative, jnative)
    A = _counts(seed=5)
    src, dst = (jnative, tnative) if writer == "jax" else (tnative, jnative)
    path = str(tmp_path / "x.svc")
    src.svc_write(path, A)
    assert os.path.exists(path + ".npz")
    np.testing.assert_array_equal(dst.svc_read(path).toarray(), A.toarray())
    assert tnative.svc_shape(path) == (A.shape[0], A.shape[1], A.nnz)


def test_read_mtx_matches_scipy(libs, tmp_path):
    A = sp.random(80, 50, density=0.1, random_state=3, dtype=np.float32,
                  format="csc")
    A.data = np.round(np.abs(A.data) * 10 + 1, 3).astype(np.float32)
    plain = tmp_path / "m.mtx"
    scipy.io.mmwrite(str(plain), A)
    gz = tmp_path / "m.mtx.gz"
    gz.write_bytes(gzip.compress(plain.read_bytes()))
    want = scipy.io.mmread(str(plain)).toarray()
    for path in (plain, gz):
        B = tnative.read_mtx(str(path))
        assert B.shape == A.shape and B.dtype == np.float32
        np.testing.assert_allclose(B.toarray(), want, rtol=1e-6)
        np.testing.assert_array_equal(
            B.toarray(), jnative.read_mtx(str(path)).toarray())


def test_transpose_ell_and_log_normalize_match_jax(libs, monkeypatch):
    A = _sparse(80, 50, density=0.15, seed=4)
    T = tnative.csc_transpose(A)
    np.testing.assert_array_equal(T.toarray(), A.T.toarray())
    for c in range(T.shape[1]):
        assert (np.diff(T.indices[T.indptr[c]:T.indptr[c + 1]]) > 0).all()
    max_nnz = int(np.diff(A.indptr).max()) + 3
    for got, want in zip(tnative.csc_to_ell(A, 64, max_nnz, 99),
                         jnative.csc_to_ell(A, 64, max_nnz, 99)):
        np.testing.assert_array_equal(got, want)
    got = tnative.log_normalize_inplace(A, 1e4)
    np.testing.assert_array_equal(
        got.toarray(), jnative.log_normalize_inplace(A, 1e4).toarray())
    _no_lib(monkeypatch, tnative)
    np.testing.assert_allclose(
        tnative.log_normalize_inplace(A, 1e4).toarray(), got.toarray(),
        rtol=1e-5)
    np.testing.assert_array_equal(tnative.csc_transpose(A).toarray(),
                                  T.toarray())


def test_library_name_covers_flags_and_host(libs, monkeypatch):
    """The library's file name carries the flags and the target that
    -march=native resolves to, so a build for another host or with other
    flags is never loaded; it lives in build/, not in the package."""
    cxx = tnative.find_cxx()
    path = tnative.library_path(cxx)
    assert path.parent == tnative.BUILD_DIR
    assert tnative.BUILD_DIR.parts[-2:] == ("build", "singlet_tpu_torch")
    assert path.is_file()
    assert not list(tnative.SOURCE.parent.glob("*.so"))
    monkeypatch.setattr(tnative, "CXX_FLAGS", tnative.CXX_FLAGS + ("-g",))
    assert tnative.library_path(cxx) != path
    monkeypatch.undo()
    monkeypatch.setattr(tnative, "_host_target",
                        lambda c: b"-march=another-host")
    assert tnative.library_path(cxx) != path


def test_missing_compiler_falls_back(monkeypatch, tmp_path):
    """Without a compiler ``build`` raises and the bindings take their
    fallbacks."""
    monkeypatch.setenv("CXX", str(tmp_path / "no-such-g++"))
    with pytest.raises(RuntimeError, match="g\\+\\+ not found"):
        tnative.build()
    monkeypatch.setattr(tnative, "_LIB", None)
    assert not tnative.available()
    A = _sparse(40, 30, seed=6)
    width = tell.bell_width(tell.bell_widths(A, 2, 32))
    li, lv = tnative.csc_to_bell(A, 32, 32, 2, width)
    dense = np.zeros((32, 64), np.float32)
    for gb in range(2):
        for c in range(30):
            live = li[gb, c] >= 0
            dense[c, gb * 32 + li[gb, c][live]] = lv[gb, c][live]
    np.testing.assert_array_equal(dense[:30, :40].T, A.toarray())

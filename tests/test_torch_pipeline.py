"""The port's pipeline and CLI (``singlet_tpu_torch/pipeline.py``) against
the JAX package's on the CPU, and on a world of ranks.

The CLI runs on a 10x directory, an ``.h5ad`` and a Seurat ``.rds``
written here, once in each package from one numpy ``init_w`` (as
tests/test_torch_masked.py shares it), with a fixed rank, a rank list and
``auto``; the saved models agree within the JAX package's fit tolerance
(rtol 5e-3, atol 5e-4, tests/test_als.py).

A world of 2 gloo ranks runs the pipeline as subprocesses of this file
(``python tests/test_torch_pipeline.py --worker pipeline 2 <rank> <dir>
...``, joined through a ``FileStore`` in ``tmp_path`` by the harness of
tests/test_torch_mesh.py, 120 s, failing rather than skipping): its model
agrees with one process within the fit gate, only rank 0 writes files,
and a ``--devices`` that differs from the world's size raises. JAX is
imported only inside the test functions, so the workers never import it.
"""

import json
import os
import sys

import numpy as np
import pytest
import scipy.sparse as sp

HERE = os.path.dirname(os.path.abspath(__file__))
FIT = dict(rtol=5e-3, atol=5e-4)
CLI = ["--maxit", "30", "--tol", "1e-4", "--verbose", "0", "--seed", "5"]
GENES, CELLS = 60, 48


def _counts():
    """A planted rank-3 counts matrix with a cell type (tests/
    test_torch_experiment.py's operand)."""
    rng = np.random.default_rng(21)
    types = np.repeat(["T", "B", "NK"], CELLS // 3)
    H = rng.random((3, CELLS)) * 0.3
    for f, t in enumerate(("T", "B", "NK")):
        H[f, types == t] += 2.0
    W = rng.random((GENES, 3)) ** 2
    M = sp.csc_matrix(rng.poisson(W @ H * 3.0).astype(np.float64))
    genes = [f"G{i}" for i in range(GENES)]
    cells = [f"C{i}" for i in range(CELLS)]
    return M, genes, cells, {"cell_type": list(types)}


def _draw(k, genes_pad, genes_true, seed):
    w = np.random.default_rng(seed).random((genes_pad, k))
    w[genes_true:] = 0.0
    return w.astype(np.float32)


def _port_shared_init(setattr_):
    """One numpy init for every fit of the port (``setattr_`` is
    ``monkeypatch.setattr`` or ``setattr``)."""
    import torch

    from singlet_tpu_torch.parallel import sharded_ell
    from singlet_tpu_torch.solvers import als, ard, drivers

    for mod in (als, ard, drivers, sharded_ell):
        setattr_(mod, "init_w", lambda k, gp, gt, seed, device=None:
                 torch.as_tensor(_draw(k, gp, gt, seed), device=device))


def _jax_shared_init(monkeypatch):
    import jax.numpy as jnp

    from singlet_tpu.solvers import als, ard, drivers

    for mod in (als, ard, drivers):
        monkeypatch.setattr(mod, "init_w", lambda k, gp, gt, seed:
                            jnp.asarray(_draw(k, gp, gt, seed)))


@pytest.fixture(autouse=True)
def _one_torch_thread():
    import torch

    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _write_input(kind, directory):
    """The operand as a 10x directory, an .h5ad or a Seurat .rds."""
    from test_torch_frontends import _rds_writers, _write_10x

    M, genes, cells, meta = _counts()
    if kind == "10x":
        path = os.path.join(directory, "tenx")
        _write_10x(path, M, genes, cells, gz=True)
    elif kind == "h5ad":
        pytest.importorskip("h5py")
        from singlet_tpu_torch.data import CellDataset, write_h5ad

        path = os.path.join(directory, "data.h5ad")
        write_h5ad(path, CellDataset(
            counts=sp.csc_matrix(M.astype(np.float32)), gene_names=genes,
            cell_names=cells,
            meta={"cell_type": np.asarray(meta["cell_type"])}))
    else:
        path = os.path.join(directory, "obj.rds")
        _rds_writers()._write_seurat_rds(path, M, genes, cells, meta)
    return path


def _load(stem):
    from singlet_tpu_torch.model import NMFModel

    return NMFModel.load(stem)


@pytest.mark.parametrize("kind,k", [("10x", "3"), ("h5ad", "2,3"),
                                    ("rds", "auto")])
def test_cli_matches_jax(tmp_path, monkeypatch, kind, k):
    import singlet_tpu.pipeline as jpipe
    import singlet_tpu_torch.pipeline as tpipe

    path = _write_input(kind, str(tmp_path))
    _jax_shared_init(monkeypatch)
    _port_shared_init(monkeypatch.setattr)
    stems = {}
    for name, mod, extra in (("jax", jpipe, []),
                             ("torch", tpipe, ["--device", "cpu"])):
        stems[name] = str(tmp_path / name / "model")
        os.makedirs(os.path.dirname(stems[name]))
        assert mod.main([path, "--k", k, "-o", stems[name], *CLI,
                         *extra]) == 0
    got, want = _load(stems["torch"]), _load(stems["jax"])
    assert got.gene_names == want.gene_names
    assert got.cell_names == want.cell_names
    for f in ("w", "d", "h"):
        np.testing.assert_allclose(getattr(got, f), getattr(want, f), **FIT,
                                   err_msg=f)
    sj = json.loads(open(stems["jax"] + ".summary.json").read())
    st = json.loads(open(stems["torch"] + ".summary.json").read())
    assert {key: st[key] for key in ("k", "n_genes", "n_cells")} == \
        {key: sj[key] for key in ("k", "n_genes", "n_cells")}
    ann = sorted(f for f in os.listdir(tmp_path / "jax")
                 if ".annotations." in f)
    assert ann == sorted(f for f in os.listdir(tmp_path / "torch")
                         if ".annotations." in f)
    # a 10x directory carries no metadata to annotate
    assert bool(ann) == (kind != "10x")


def test_pipeline_writes_h5ad_and_refuses_a_world_mismatch(tmp_path):
    """h5ad_out on one process; n_devices=2 without a world of 2 raises."""
    pytest.importorskip("h5py")
    from singlet_tpu_torch.data import read_h5ad
    from singlet_tpu_torch.pipeline import cellxgene_pipeline

    path = _write_input("10x", str(tmp_path))
    out = str(tmp_path / "m")
    model = cellxgene_pipeline(path, out=out, k=3, maxit=5, verbose=0,
                               h5ad_out=out + ".h5ad", device="cpu")
    back = read_h5ad(out + ".h5ad")
    assert back.n_cells == CELLS and model.h.shape == (3, CELLS)
    with pytest.raises(ValueError, match="world of 1"):
        cellxgene_pipeline(path, out=out, k=3, maxit=5, verbose=0,
                           n_devices=2, device="cpu")


# ------------------------------------------------------------ the world

def pipeline(mesh, out, path, mode):
    """One rank's pipeline in its own working directory (so that a file a
    rank writes shows up there), or, with mode "mismatch", the pipeline
    asked for a world of 3."""
    import torch.distributed as dist

    from singlet_tpu_torch.pipeline import cellxgene_pipeline

    rank = dist.get_rank()
    wd = os.path.join(out, f"wd{rank}")
    os.makedirs(wd, exist_ok=True)
    os.chdir(wd)
    _port_shared_init(setattr)
    if mode == "mismatch":
        try:
            cellxgene_pipeline(path, out="model", k=3, n_devices=3,
                               device="cpu", verbose=0)
        except ValueError as e:
            assert "world of 2" in str(e), e
            return dict(raised=np.asarray(1))
        return dict(raised=np.asarray(0))
    model = cellxgene_pipeline(path, out="model", k=3, maxit=30, tol=1e-4,
                               seed=5, verbose=0, n_devices=2, device="cpu")
    return dict(w=model.w, d=model.d, h=model.h,
                files=np.asarray(sorted(os.listdir(wd)), dtype=str))


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    from test_torch_mesh import World

    tmp = tmp_path_factory.mktemp("pipeline_world")
    path = _write_input("rds", str(tmp))
    worlds = {mode: World(tmp, os.path.abspath(__file__), "pipeline", 2,
                          path, mode) for mode in ("fit",)}
    yield path, worlds
    for w in worlds.values():
        w.stop()


def test_world_of_two_ranks_matches_one_process(world, tmp_path,
                                                monkeypatch):
    """Each rank returns the same model, within the fit gate of one
    process's; rank 0 alone wrote the model, its sidecars and the
    summary."""
    from singlet_tpu_torch.pipeline import cellxgene_pipeline

    path, worlds = world
    ranks = worlds["fit"].results()
    _port_shared_init(monkeypatch.setattr)
    want = cellxgene_pipeline(path, out=str(tmp_path / "one"), k=3, maxit=30,
                              tol=1e-4, seed=5, verbose=0, device="cpu")
    for r in ranks:
        for f in ("w", "d", "h"):
            np.testing.assert_allclose(r[f], getattr(want, f), **FIT,
                                       err_msg=f)
        np.testing.assert_array_equal(r["w"], ranks[0]["w"])
    files = list(ranks[0]["files"])
    assert {"model.npz", "model.json", "model.summary.json"} <= set(files)
    assert any(".annotations." in f for f in files)
    assert list(ranks[1]["files"]) == []


def test_world_refuses_a_devices_mismatch(tmp_path):
    from test_torch_mesh import World

    path = _write_input("10x", str(tmp_path))
    w = World(tmp_path, os.path.abspath(__file__), "pipeline", 2, path,
              "mismatch")
    try:
        assert [int(r["raised"]) for r in w.results()] == [1, 1]
    finally:
        w.stop()


if __name__ == "__main__" and sys.argv[1:2] == ["--worker"]:
    sys.path.insert(0, HERE)
    from test_torch_mesh import worker_main

    worker_main({"pipeline": pipeline})

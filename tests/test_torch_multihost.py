"""Per-rank ingest, the process runtime, resumable fits and the masked
kernel routes on a mesh of ranks (``singlet_tpu_torch/parallel/``), on the
CPU; the worlds run as in tests/test_torch_mesh.py (gloo subprocesses of
this file under a ``FileStore``, at most 120 s each).

  * ingest: each rank's planes, ``nonempty`` and ``gene_nonempty`` equal
    the rank's slice of the JAX ``shard_ell_data(A, make_mesh(n))`` bit for
    bit, from ``shard_ell_data``, ``shard_ell_from_local``,
    ``shard_ell_from_chunks`` and ``shard_ell_from_staged``, at 2 and 4
    ranks (at 4, rank 3 holds padding only); the dense ``shard_data`` and
    ``shard_cells_from_local`` equal the slice of the JAX ``shard_data``;
  * a checkpointed fit and ``ard_fit``, and the ``ard_nmf`` search state,
    stopped and resumed at 2 ranks give the uninterrupted one bit for bit,
    and the metric log is written once, by rank 0;
  * the bits route (int8, and under ``SINGLET_TPU_MASK8=1``) and the hash
    route at 2 ranks, forced as tests/test_torch_sharded_ell_bits.py forces
    them (``_kernel_device`` patched), against the port's world of one at
    that file's tolerances (rtol 5e-3, atol 5e-4 on factors and test MSE,
    equal ``iter`` lists);
  * a world of one in this process (``make_mesh()``) gives the bits of the
    fits with no mesh; on it a checkpoint manager's ``save(it, state)`` is
    called as with no mesh, and ``nmf_batch`` / ``gcnmf`` take every input
    ``run_nmf`` takes (scipy, dense, chunk list, staged directory, engine)
    with the engine's bits;
  * a ``LOCAL_RANK`` (or process id) past the host's cards raises.
"""

import os
import sys

import numpy as np
import pytest
import scipy.sparse as sp

from test_torch_mesh import World, batch_of, ring, worker_main

FIT = dict(rtol=5e-3, atol=5e-4)
BLOCKS = (256, 32)
BOUNDS = [0, 130, 390, 600]
# the masked routes: two blocks of 512 cells on each of 2 ranks (one group
# of F = 2 for B9), two gene blocks
ROUTE = dict(genes=512, cells=2048, cell_block=512, gene_block=256, k=5)
ROUTES = {"int8": dict(), "mask8": dict(SINGLET_TPU_MASK8="1"),
          "hash": dict(SINGLET_TPU_MASKGRAM="hash")}


def operand():
    """60 x 600, with empty cells and genes."""
    A = sp.random(60, 600, density=0.1, random_state=7, dtype=np.float32,
                  format="lil")
    A[:, [3, 450, 599]] = 0
    A[[5, 40], :] = 0
    A = sp.csc_matrix(A)
    A.eliminate_zeros()
    A.data = np.abs(A.data) + 0.1
    return A


def chunks():
    A = operand()
    return [sp.csc_matrix(A[:, a:b]) for a, b in zip(BOUNDS, BOUNDS[1:])]


def route_operand():
    A = sp.random(ROUTE["genes"], ROUTE["cells"], density=0.05,
                  random_state=3, dtype=np.float32, format="csc")
    A.data = np.abs(A.data) + 0.1
    return A


def _planes(data) -> dict:
    return dict(b_li=data.b_li.numpy(), b_val=data.b_val.numpy(),
                nonempty=data.nonempty.numpy(),
                gene_nonempty=data.gene_nonempty.numpy(),
                geometry=np.asarray([data.b_width, data.genes_pad,
                                     data.cells_pad, data.cell_block,
                                     data.gene_block, data.cell_offset,
                                     data.cells_local]))


def ingest(mesh, out, staged):
    import singlet_tpu_torch as stt
    from singlet_tpu_torch.parallel import sharded_ell as tell
    from singlet_tpu_torch.parallel.collectives import rank_of

    A = operand()
    kw = dict(cell_block=BLOCKS[0], gene_block=BLOCKS[1], mesh=mesh)
    res = {}
    full = tell.shard_ell_data(A, "cpu", **kw)
    lo, hi = full.cell_offset, full.cell_offset + full.cells_local
    local = A[:, min(lo, 600):min(hi, 600)]
    for name, data in (
            ("data", full),
            ("local", tell.shard_ell_from_local(local, 600, mesh, *BLOCKS,
                                                device="cpu")),
            ("chunks", tell.shard_ell_from_chunks(chunks(), "cpu", **kw)),
            ("staged", tell.shard_ell_from_staged(staged, "cpu", **kw))):
        res.update({f"{name}_{f}": v for f, v in _planes(data).items()})
    D = operand().toarray()
    sd = stt.shard_data(D, mesh, device="cpu")
    start, stop = stt.process_cell_range(60, 600, mesh)
    sl = stt.shard_cells_from_local(D[:, min(start, 600):min(stop, 600)],
                                    600, mesh, device="cpu")
    for name, data in (("dense", sd), ("dense_local", sl)):
        res.update({f"{name}_A": data.A.numpy(),
                    f"{name}_nonempty": data.nonempty.numpy(),
                    f"{name}_gene_nonempty": data.gene_nonempty.numpy(),
                    f"{name}_range": np.asarray([data.cell_offset,
                                                 data.cells_local])})
    res["range"] = np.asarray([start, stop, rank_of(mesh)])
    return res


def resume(mesh, out):
    import singlet_tpu_torch as stt
    from singlet_tpu_torch.tracing import metric_logging

    eng = stt.ShardedEllEngine(operand(), mesh=mesh, device="cpu",
                               cell_block=BLOCKS[0], gene_block=BLOCKS[1])
    w0 = np.random.default_rng(1).random((60, 3)).astype(np.float32)
    res = {}
    with metric_logging(os.path.join(out, "metrics.jsonl")):
        for name, fit in (
                ("fit", lambda maxit, ck: eng.fit(
                    3, tol=0.0, maxit=maxit, w_init=w0, checkpoint=ck)),
                ("ard", lambda maxit, ck: eng.ard_fit(
                    3, w_init=w0, maxit=maxit, tol=0.0, checkpoint=ck,
                    overfit_threshold=1.0))):
            full = fit(4, stt.CheckpointManager(
                os.path.join(out, f"{name}_full"), every=1))
            fit(2, stt.CheckpointManager(os.path.join(out, name), every=1))
            got = fit(4, stt.CheckpointManager(os.path.join(out, name),
                                               every=1))
            for tag, r in (("full", full), ("resumed", got)):
                r = r if isinstance(r, dict) else vars(r)
                res.update({f"{name}_{tag}_{f}": np.asarray(r[f]) for f in
                            ("w", "d", "h")})
    # the ard_nmf search state: stopped by max_fits, resumed
    kw = dict(k_max=5, maxit=3, verbose=0, trace_test_mse=1,
              test_density=0.1, seed=2, device="cpu", mesh=mesh)
    full = stt.ard_nmf(operand(), **kw)
    ck = os.path.join(out, "search")
    stt.ard_nmf(operand(), checkpoint=ck, max_fits=2, **kw)
    got = stt.ard_nmf(operand(), checkpoint=ck, **kw)
    for tag, m in (("full", full), ("resumed", got)):
        res.update({f"search_{tag}_{f}": np.asarray(getattr(m, f))
                    for f in ("w", "d", "h")})
        res[f"search_{tag}_test_error"] = m.cv_data["test_error"].to_numpy()
    return res


def routes(mesh, out):
    import singlet_tpu_torch as stt
    from singlet_tpu_torch.parallel import sharded_ell as tell

    tell._kernel_device = lambda device: True
    return route_fits(stt, mesh)


def route_fits(stt, mesh) -> dict:
    """ard_fit on each forced masked route, on ``mesh`` (None: no mesh)."""
    eng = stt.ShardedEllEngine(route_operand(), mesh=mesh, device="cpu",
                               cell_block=ROUTE["cell_block"],
                               gene_block=ROUTE["gene_block"])
    w0 = np.random.default_rng(2).random(
        (ROUTE["genes"], ROUTE["k"])).astype(np.float32)
    res = {}
    for name, env in ROUTES.items():
        old = {key: os.environ.get(key) for key in env}
        os.environ.update(env)
        try:
            a = eng.ard_fit(ROUTE["k"], w_init=w0, maxit=3, tol=0.0,
                            overfit_threshold=1.0)
        finally:
            for key, v in old.items():
                if v is None:
                    os.environ.pop(key, None)
                else:
                    os.environ[key] = v
        res.update({f"{name}_{f}": np.asarray(getattr(a, f)) for f in
                    ("w", "d", "h", "test_mse", "iter", "tol")})
    return res


SCENARIOS = {"ingest": ingest, "resume": resume, "routes": routes}


@pytest.fixture(scope="module")
def _worlds(tmp_path_factory):
    """Every world of this file, started together: ingest at 2 and 4
    ranks (from one staged directory), resume and routes at 2."""
    from singlet_tpu_torch.sparse.chunked import stage_chunks

    tmp = tmp_path_factory.mktemp("multihost")
    staged = stage_chunks(str(tmp / "staged"), chunks())
    worlds = {("ingest", n): World(tmp, __file__, "ingest", n, staged)
              for n in (2, 4)}
    worlds["resume", 2] = World(tmp, __file__, "resume", 2)
    worlds["routes", 2] = World(tmp, __file__, "routes", 2)
    yield worlds
    for w in worlds.values():
        w.stop()


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    import torch

    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ------------------------------------------------------------ ingest

@pytest.mark.parametrize("n", [2, 4])
@pytest.mark.parametrize("how", ["data", "local", "chunks", "staged"])
def test_rank_planes_are_the_jax_shards(_worlds, n, how):
    from singlet_tpu.parallel import sharded_ell as jell
    from singlet_tpu.parallel.sharded import make_mesh

    jd = jell.shard_ell_data(operand(), make_mesh(n), *BLOCKS)
    cl = jd.cells_pad // n
    for r, got in enumerate(_worlds["ingest", n].results()):
        sl = slice(r * cl, (r + 1) * cl)
        want = dict(b_li=np.asarray(jd.b_li)[:, sl],
                    b_val=np.asarray(jd.b_val)[:, sl],
                    nonempty=np.asarray(jd.nonempty)[sl],
                    gene_nonempty=np.asarray(jd.gene_nonempty))
        for f, v in want.items():
            assert got[f"{how}_{f}"].dtype == v.dtype, f
            np.testing.assert_array_equal(got[f"{how}_{f}"], v,
                                          err_msg=f"rank {r} {f}")
        np.testing.assert_array_equal(
            got[f"{how}_geometry"],
            [jd.b_width, jd.genes_pad, jd.cells_pad, jd.cell_block,
             jd.gene_block, r * cl, cl])
    if n == 4:
        # rank 3 holds padding only: no nonempty cell, every plane a pad
        last = _worlds["ingest", n].results()[3]
        assert not last[f"{how}_nonempty"].any()
        assert (last[f"{how}_b_li"] == -1).all()


@pytest.mark.parametrize("n", [2, 4])
def test_dense_rank_columns_are_the_jax_shards(_worlds, n):
    from singlet_tpu.parallel.sharded import make_mesh, shard_data

    sd = shard_data(operand().toarray(), make_mesh(n))
    A, ne = np.asarray(sd.A), np.asarray(sd.nonempty)
    gne = (A != 0).any(axis=1)
    cl = sd.cells_pad // n
    for r, got in enumerate(_worlds["ingest", n].results()):
        assert list(got["range"]) == [r * cl, (r + 1) * cl, r]
        for name in ("dense", "dense_local"):
            np.testing.assert_array_equal(got[f"{name}_A"],
                                          A[:, r * cl:(r + 1) * cl])
            np.testing.assert_array_equal(got[f"{name}_nonempty"],
                                          ne[r * cl:(r + 1) * cl])
            np.testing.assert_array_equal(got[f"{name}_gene_nonempty"], gne)
            assert list(got[f"{name}_range"]) == [r * cl, cl]


def test_runtime_on_one_process():
    """``initialize()`` is a no-op with one process; ``make_mesh(n)`` with
    no world raises; a mesh of the wrong kind raises TypeError; a rank's
    range on no mesh is everything."""
    import torch.distributed as dist

    import singlet_tpu_torch as stt
    from singlet_tpu_torch.parallel.sharded import check_mesh

    stt.initialize()
    assert not dist.is_initialized()
    with pytest.raises(ValueError, match="processes"):
        stt.make_mesh(2, device="cpu")
    with pytest.raises(TypeError, match="DeviceMesh.*cells"):
        check_mesh(object())
    assert stt.process_cell_range(60, 600, None) == (0, 768)


# ------------------------------------------------------------ resume

@pytest.mark.parametrize("fit", ["fit", "ard", "search"])
def test_resumed_fit_on_mesh_is_bit_for_bit(_worlds, fit):
    """A checkpointed fit, ard_fit and ard_nmf search stopped and resumed
    at 2 ranks give the uninterrupted one bit for bit, on both ranks."""
    ranks = _worlds["resume", 2].results()
    fields = ("w", "d", "h") + (("test_error",) if fit == "search" else ())
    for r, got in enumerate(ranks):
        for f in fields:
            np.testing.assert_array_equal(got[f"{fit}_resumed_{f}"],
                                          got[f"{fit}_full_{f}"],
                                          err_msg=f"rank {r} {f}")
            np.testing.assert_array_equal(got[f"{fit}_full_{f}"],
                                          ranks[0][f"{fit}_full_{f}"])


def test_one_device_save_keeps_its_call(tmp_path):
    """With no mesh and on a world of one the fits and the ard_nmf search
    call ``CheckpointManager.save(it, state)``, as a subclass that
    overrides ``save`` takes it."""
    import torch.distributed as dist

    import singlet_tpu_torch as stt

    calls = []

    class Mgr(stt.CheckpointManager):
        def save(self, it, state):
            calls.append(it)
            return super().save(it, state)

    def fits(mesh, where):
        calls.clear()
        eng = stt.ShardedEllEngine(operand(), mesh=mesh, device="cpu",
                                   cell_block=BLOCKS[0],
                                   gene_block=BLOCKS[1])
        eng.fit(3, tol=0.0, maxit=2,
                checkpoint=Mgr(str(tmp_path / where / "f"), every=1))
        assert calls == [1, 2]
        stt.ard_nmf(operand().toarray(), k_max=3, maxit=2, verbose=0,
                    device="cpu", mesh=mesh,
                    checkpoint=Mgr(str(tmp_path / where / "s"), every=1))
        assert len(calls) > 2

    fits(None, "none")
    mesh = stt.make_mesh(device="cpu")
    try:
        fits(mesh, "mesh")
    finally:
        dist.destroy_process_group()


def test_local_rank_past_the_cards_raises(monkeypatch):
    """A rank's card is ``LOCAL_RANK``, else its process id; one past the
    host's cards (none here) raises, and is never folded onto another."""
    from singlet_tpu_torch.parallel.sharded import _local_index

    monkeypatch.setenv("LOCAL_RANK", "0")
    with pytest.raises(RuntimeError, match="LOCAL_RANK 0 has no card"):
        _local_index(fallback=1)
    monkeypatch.delenv("LOCAL_RANK")
    with pytest.raises(RuntimeError, match="process 1 has no card"):
        _local_index(fallback=1)


def test_metric_log_written_by_rank_zero(_worlds):
    import json

    w = _worlds["resume", 2]
    w.results()
    with open(os.path.join(w.out, "metrics.jsonl")) as f:
        events = [json.loads(line) for line in f]
    starts = [e for e in events if e["event"] == "fit_start"]
    # 3 fits (full, cut, resumed) of each of fit and ard_fit, once each
    assert len(starts) == 6
    assert all(e["n_devices"] == 2 for e in starts)


# ------------------------------------------------------------ routes

@pytest.fixture(scope="module")
def _world_of_none():
    """The route fits with no mesh (a world of one gives their bits:
    test_world_of_one_gives_the_bits_of_no_mesh)."""
    import singlet_tpu_torch as stt
    from singlet_tpu_torch.parallel import sharded_ell as tell

    real = tell._kernel_device
    tell._kernel_device = lambda device: True
    try:
        return route_fits(stt, None)
    finally:
        tell._kernel_device = real


@pytest.mark.parametrize("route", sorted(ROUTES))
def test_masked_routes_on_mesh_match_world_of_one(_worlds, _world_of_none,
                                                  route):
    want = _world_of_none
    for r, got in enumerate(_worlds["routes", 2].results()):
        np.testing.assert_array_equal(got[f"{route}_iter"],
                                      want[f"{route}_iter"])
        np.testing.assert_allclose(got[f"{route}_test_mse"],
                                   want[f"{route}_test_mse"], rtol=5e-3)
        np.testing.assert_allclose(got[f"{route}_tol"], want[f"{route}_tol"],
                                   rtol=5e-3, atol=1e-5)
        for f in ("w", "d", "h"):
            np.testing.assert_allclose(got[f"{route}_{f}"],
                                       want[f"{route}_{f}"], **FIT,
                                       err_msg=f"rank {r} {f}")


# ------------------------------------------------------------ world of one

def test_world_of_one_gives_the_bits_of_no_mesh(monkeypatch):
    """``make_mesh()`` in this process starts a world of one over gloo; the
    ELL engine's plain, masked and bits-route fits, ``run_nmf`` and the
    dense mesh engine on it equal those with no mesh, bit for bit."""
    import torch.distributed as dist

    import singlet_tpu_torch as stt
    from singlet_tpu_torch.parallel import sharded_ell as tell

    A = operand()
    w0 = np.random.default_rng(1).random((60, 3)).astype(np.float32)

    def fits(mesh):
        eng = stt.ShardedEllEngine(A, mesh=mesh, device="cpu",
                                   cell_block=BLOCKS[0],
                                   gene_block=BLOCKS[1])
        out = dict(plain=eng.fit(3, tol=0.0, maxit=3, w_init=w0),
                   masked=eng.fit(3, tol=0.0, maxit=3, w_init=w0,
                                  masked=True),
                   dense=stt.sharded_nmf_fit(A.toarray(), 3, mesh=mesh,
                                             tol=0.0, maxit=3, w_init=w0,
                                             masked=True, device="cpu"))
        # with a mesh run_nmf fits on the engine: without one, hand it one
        m = stt.run_nmf(A if mesh else stt.ShardedEllEngine(A, device="cpu"),
                        rank=3, w_init=w0, tol=0.0, maxit=3, mesh=mesh,
                        device="cpu")
        out["run_nmf"] = dict(w=m.w, d=m.d, h=m.h)
        monkeypatch.setattr(tell, "_kernel_device", lambda device: True)
        a = eng.ard_fit(3, w_init=w0, maxit=3, tol=0.0)
        monkeypatch.undo()
        out["bits"] = dict(w=a.w, d=a.d, h=a.h, test_mse=a.test_mse)
        return out

    want = fits(None)
    assert not dist.is_initialized()
    mesh = stt.make_mesh(device="cpu")
    try:
        assert mesh.size() == 1 and dist.get_backend() == "gloo"
        got = fits(mesh)
    finally:
        dist.destroy_process_group()
    for name, fit in want.items():
        for f, v in fit.items():
            np.testing.assert_array_equal(np.asarray(got[name][f]),
                                          np.asarray(v),
                                          err_msg=f"{name} {f}")


@pytest.mark.parametrize("solver", ["batch", "gcnmf"])
def test_solvers_on_mesh_take_every_input(tmp_path, solver):
    """On a world of one, ``nmf_batch`` and ``gcnmf`` with ``mesh=`` route
    the input as ``run_nmf`` does: a scipy matrix, a dense array, a chunk
    list, a staged directory and an engine give the engine's bits."""
    import torch.distributed as dist

    import singlet_tpu_torch as stt
    from singlet_tpu_torch.solvers.drivers import _finalize
    from singlet_tpu_torch.sparse.chunked import stage_chunks

    A = operand()
    w0 = np.random.default_rng(1).random((60, 3)).astype(np.float32)
    kw = dict(tol=0.0, maxit=3, w_init=w0, device="cpu")
    staged = stage_chunks(str(tmp_path / "staged"), chunks())
    mesh = stt.make_mesh(device="cpu")
    try:
        eng = stt.ShardedEllEngine(A, mesh=mesh, device="cpu")
        if solver == "batch":
            want = eng.batch_fit(batch_of(600), 3, tol=0.0, maxit=3,
                                 w_init=w0)
            fit = lambda X: stt.nmf_batch(X, 3, batch_of(600),  # noqa: E731
                                          mesh=mesh, **kw)
        else:
            want = eng.gcnmf_fit(ring(600), 3, tol=0.0, maxit=3, w_init=w0)
            fit = lambda X: stt.gcnmf(X, ring(600), 3,  # noqa: E731
                                      mesh=mesh, **kw)
        got = {name: fit(X) for name, X in (
            ("scipy", A), ("dense", A.toarray()), ("chunks", chunks()),
            ("staged", staged), ("engine", eng))}
    finally:
        dist.destroy_process_group()
    want = _finalize(want["w"], want["d"], want["h"], None, None)
    for name, m in got.items():
        for f in ("w", "d", "h"):
            np.testing.assert_array_equal(getattr(m, f), getattr(want, f),
                                          err_msg=f"{name} {f}")


if __name__ == "__main__" and sys.argv[1:2] == ["--worker"]:
    worker_main(SCENARIOS)

"""The cell mesh over ``torch.distributed`` and the dense mesh engine.

Port of ``singlet_tpu/parallel/sharded.py``. The JAX package runs one
process over a 1-D device mesh and lets ``shard_map`` place the
collectives; the port runs one process per device (as ``torchrun`` starts
them), and a JAX mesh of N devices is here a world of N ranks with a 1-D
``DeviceMesh`` whose dimension is named ``"cells"``:

  * A (genes x cells) is split on the cell axis: each rank holds the dense
    columns of its own range ``[rank * cells_local, (rank + 1) *
    cells_local)`` and packs no other;
  * H (cells x k) is split the same way; W (genes x k) is replicated;
  * the h-update is the rank's own (kernel B1 over its cells, the masked
    one B2 per cell block); the w-update's right-hand sides, Grams and
    packed Gram corrections are reduced over the ranks
    (``collectives.psum``, NCCL on the card, gloo on the CPU) at the JAX
    engine's points and in its order, and the gene solve runs replicated
    on every rank from the reduced operands, so every rank holds W with
    the same bits;
  * the test mask is keyed by GLOBAL cell ids, so each rank derives its
    test set with no communication.

``make_mesh`` joins the initialized world, or starts a world of one when
none is (NCCL on a card, gloo on the CPU, a local store): the JAX
``make_mesh(1)`` on one chip. A mesh=None fit runs on one device with no
collective at all, and a world of one gives its bits.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

from singlet_tpu_torch.device import resolve_device
from singlet_tpu_torch.ops.linalg import (cor_distance, gram, mask_dot_t,
                                          packed_outer_products,
                                          scale_columns, triu_pairs)
from singlet_tpu_torch.ops.nnls import (CD_MAX_SWEEPS, SweepSettings,
                                        solve_nnls, solve_nnls_packed_t)
from singlet_tpu_torch.ops.rngmask import mask_block, seed_pair
from singlet_tpu_torch.parallel.collectives import (all_gather_cells,
                                                    any_over_ranks, pmax,
                                                    psum, rank_of, world_of)

AXIS = "cells"

__all__ = ["AXIS", "make_mesh", "check_mesh", "rank_device", "ShardedData",
           "cell_geometry", "shard_data", "build_sharded_steps",
           "sharded_nmf_fit"]

# entries of the int64 hash temporaries per chunk of the mask build
_MASK_CHUNK = 1 << 24


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


def _local_index(fallback: Optional[int] = None) -> int:
    """The card of this process: ``LOCAL_RANK`` (as ``torchrun`` sets it),
    else ``fallback`` (a process started by hand: its rank), else the
    current CUDA device. An index past the cards there are raises: a rank
    is never folded onto another card."""
    if "LOCAL_RANK" in os.environ:
        idx, what = int(os.environ["LOCAL_RANK"]), "LOCAL_RANK"
    elif fallback is not None:
        idx, what = int(fallback), "process"
    else:
        return torch.cuda.current_device()
    n = torch.cuda.device_count()
    if idx >= n:
        raise RuntimeError(
            f"{what} {idx} has no card of its own: this host has {n} CUDA "
            "device(s). Start one process per card, or name each rank's "
            "device (device='cuda:0' with backend='gloo' to share one card)")
    return idx


def rank_device(mesh=None, device=None) -> torch.device:
    """This rank's device: ``device`` when given; on a CPU mesh the CPU; on
    a CUDA mesh ``cuda:{LOCAL_RANK}`` (the current card without it);
    without a mesh ``resolve_device(None)``, the card."""
    if device is not None or mesh is None:
        return resolve_device(device)
    if mesh.device_type == "cpu":
        return resolve_device("cpu")
    return resolve_device(torch.device(mesh.device_type, _local_index()))


def make_mesh(n_devices: Optional[int] = None, device=None) -> DeviceMesh:
    """The 1-D ``"cells"`` mesh over the initialized world, device type
    that of ``device`` (default ``"cuda"``).

    With no process group initialized the world is one rank: it is started
    here (NCCL on a card, gloo on the CPU, a local store), the JAX
    ``make_mesh(1)`` on one chip; ``n_devices`` other than 1 then raises,
    since a world of N ranks is N processes (``torchrun``, or
    ``multihost.initialize`` in each). The mesh is built from the existing
    world group (``DeviceMesh.from_group``), which creates no process group
    and picks no card."""
    dev = resolve_device(device)
    if not dist.is_initialized():
        if n_devices not in (None, 1):
            raise ValueError(
                f"make_mesh({n_devices}) with no process group: a world of "
                f"{n_devices} ranks is {n_devices} processes (torchrun, or "
                "parallel.multihost.initialize in each); make_mesh joins it")
        backend = "gloo"
        if dev.type == "cuda":
            torch.cuda.set_device(dev.index if dev.index is not None
                                  else _local_index())
            backend = "nccl"
        dist.init_process_group(backend=backend, store=dist.HashStore(),
                                rank=0, world_size=1)
    elif n_devices is not None and n_devices != dist.get_world_size():
        raise ValueError(f"make_mesh({n_devices}) in a world of "
                         f"{dist.get_world_size()} ranks")
    return DeviceMesh.from_group(dist.group.WORLD, dev.type,
                                 mesh_dim_names=(AXIS,))


def check_mesh(mesh):
    """``mesh`` when it is None or a 1-D ``DeviceMesh`` named ``"cells"``;
    anything else raises TypeError."""
    if mesh is None:
        return None
    if not (isinstance(mesh, DeviceMesh) and mesh.ndim == 1
            and tuple(mesh.mesh_dim_names or ()) == (AXIS,)):
        raise TypeError(
            f"mesh= takes a 1-D torch.distributed DeviceMesh whose "
            f"dimension is named {AXIS!r} (parallel.make_mesh(): one "
            f"process per device), got {mesh!r}")
    return mesh


def cell_geometry(genes: int, cells: int, n_dev: int = 1,
                  cell_block: int = 1024, gene_block: int = 2048
                  ) -> Tuple[int, int, int, int]:
    """(genes_pad, cells_pad, cell_block, gene_block) of a cell-split dense
    operand on a mesh of ``n_dev`` ranks (the JAX ``cell_geometry``): each
    rank holds ``cells_pad // n_dev`` columns, a multiple of the cell
    block. Shared by ``shard_data`` and ``multihost.shard_cells_from_local``
    so that both give the same operand."""
    cell_block = min(cell_block, _round_up(max(cells // n_dev, 1), 256))
    cells_pad = _round_up(cells, n_dev * cell_block)
    gene_block = min(gene_block, _round_up(genes, 256))
    genes_pad = _round_up(genes, gene_block)
    return genes_pad, cells_pad, cell_block, gene_block


@dataclasses.dataclass
class ShardedData:
    """The rank's dense columns of a cell-split operand, and the geometry.

    ``A`` is (genes_pad, cells_local), the columns of global cells
    ``[cell_offset, cell_offset + cells_local)``; ``nonempty`` is theirs;
    ``gene_nonempty`` is over all cells, the same on every rank."""

    A: torch.Tensor              # (genes_pad, cells_local)
    nonempty: torch.Tensor       # (cells_local,) bool
    gene_nonempty: torch.Tensor  # (genes_pad,) bool
    mesh: Optional[DeviceMesh]
    genes_true: int
    cells_true: int
    cells_pad: int
    cell_block: int              # per-rank column block of masked updates
    gene_block: int
    # the rank's test mask of the last (seed, inv_density)
    mask_cache: dict = dataclasses.field(default_factory=dict)

    @property
    def genes_pad(self) -> int:
        return self.A.shape[0]

    @property
    def device(self) -> torch.device:
        return self.A.device

    @property
    def n_dev(self) -> int:
        return world_of(self.mesh)

    @property
    def rank(self) -> int:
        return rank_of(self.mesh)

    @property
    def cells_local(self) -> int:
        return self.A.shape[1]

    @property
    def cell_offset(self) -> int:
        return self.rank * self.cells_local


def _dense_data(buf: np.ndarray, ne_local: np.ndarray,
                gene_present: np.ndarray, mesh, device, genes: int,
                cells: int, geometry, or_over_ranks: bool) -> ShardedData:
    """ShardedData on ``device`` from the rank's padded columns ``buf``,
    their nonempty flags and the genes present, OR'ed over the ranks when
    each rank saw only its own columns (``or_over_ranks``)."""
    genes_pad, cells_pad, cell_block, gene_block = geometry
    gne = torch.zeros(genes_pad, dtype=torch.bool, device=device)
    gne[:genes] = torch.as_tensor(gene_present, device=device)
    if or_over_ranks:
        gne = any_over_ranks(mesh, gne)
    return ShardedData(
        A=torch.from_numpy(buf).to(device),
        nonempty=torch.from_numpy(ne_local).to(device), gene_nonempty=gne,
        mesh=mesh, genes_true=genes, cells_true=cells, cells_pad=cells_pad,
        cell_block=cell_block, gene_block=gene_block)


def shard_data(A: np.ndarray, mesh=None, cell_block: int = 1024,
               gene_block: int = 2048, device=None) -> ShardedData:
    """Pad a genes x cells array and keep this rank's columns on its
    device (``rank_device``): each rank holds the whole array on the host
    and packs only its own range, as every JAX device holds its shard. A
    rank whose range holds only padding gets zero columns."""
    mesh = check_mesh(mesh)
    device = rank_device(mesh, device)
    A = np.asarray(A, np.float32)
    genes, cells = A.shape
    geometry = cell_geometry(genes, cells, world_of(mesh), cell_block,
                             gene_block)
    genes_pad, cells_pad, _, _ = geometry
    cells_local = cells_pad // world_of(mesh)
    lo = rank_of(mesh) * cells_local
    hi = min(lo + cells_local, cells)
    buf = np.zeros((genes_pad, cells_local), np.float32)
    ne = np.zeros(cells_local, bool)
    if hi > lo:
        buf[:genes, :hi - lo] = A[:, lo:hi]
        ne[:hi - lo] = (np.abs(A[:, lo:hi]) > 0).any(axis=0)
    # every rank holds every column here: the OR over the ranks is local
    return _dense_data(buf, ne, (A != 0).any(axis=1), mesh, device, genes,
                       cells, geometry, or_over_ranks=False)


def _rank_mask(data: ShardedData, seed, inv_density: int) -> torch.Tensor:
    """The rank's test mask, bool (cells_local, genes_pad), keyed by GLOBAL
    cell ids, with the validity clamps (padded cells and genes are never
    held out). Built at the first call for (seed, inv_density), then
    cached on ``data``: the JAX engine hashes it per block, and the port's
    eager hash is some 50 int64 passes per entry."""
    key = (int(seed[0]), int(seed[1]), int(inv_density))
    if key not in data.mask_cache:
        data.mask_cache.clear()
        dev = data.device
        m = torch.zeros((data.cells_local, data.genes_pad), dtype=torch.bool,
                        device=dev)
        off = data.cell_offset
        n_valid = max(0, min(data.cells_local, data.cells_true - off))
        gene_ids = torch.arange(data.genes_true, device=dev)
        chunk = max(1, _MASK_CHUNK // max(data.genes_true, 1))
        for c0 in range(0, n_valid, chunk):
            c1 = min(c0 + chunk, n_valid)
            m[c0:c1, :data.genes_true] = mask_block(
                seed, torch.arange(off + c0, off + c1, device=dev), gene_ids,
                inv_density)
        data.mask_cache[key] = m
    return data.mask_cache[key]


def _psum_gram(mesh, X: torch.Tensor) -> torch.Tensor:
    """X^T X summed over the ranks, + 1e-15 I (the JAX ``_psum_gram``)."""
    a = psum(mesh, X.T @ X)
    return a + 1e-15 * torch.eye(a.shape[0], dtype=a.dtype, device=a.device)


def build_sharded_steps(data: ShardedData, inv_density: int):
    """The dense mesh engine's steps over ``data``: ``plain(W, H, L1_h,
    L1_w, L2_h, L2_w, sweep_cap, max_sweeps)`` and ``masked(W, H, seed, L1,
    L2, sweep_cap, max_sweeps)``, each returning (W, H, d, tol) with H the
    rank's rows and tol the MAX over the ranks, and ``mse(W, d, H, seed)``
    (the JAX ``build_sharded_steps``)."""
    mesh = data.mesh
    A_loc, ne_loc, gene_ne = data.A, data.nonempty, data.gene_nonempty
    genes_pad, genes_true = data.genes_pad, data.genes_true
    cells_local, cells_true = data.cells_local, data.cells_true
    cell_block, gene_block = data.cell_block, data.gene_block
    assert cells_local % cell_block == 0, (cells_local, cell_block)
    assert genes_pad % gene_block == 0

    def _plain(W, H_loc, L1_h, L1_w, L2_h, L2_w, sweep_cap=None,
               max_sweeps: int = CD_MAX_SWEEPS):
        kw = dict(sweep_cap=sweep_cap, max_sweeps=max_sweeps)
        # h-update: the rank's own (W replicated, so its Gram is too)
        H_loc = solve_nnls(gram(W), A_loc.T @ W, H_loc, L1=L1_h, L2=L2_h,
                           update_mask=ne_loc, **kw)
        d = psum(mesh, H_loc.sum(dim=0)) + 1e-15
        H_loc = H_loc / d[None, :]
        # w-update: the partial products summed over the ranks (the Gram
        # and the right-hand sides in one call)
        a_h, B_w = psum(mesh, H_loc.T @ H_loc, A_loc @ H_loc)
        a_h = a_h + 1e-15 * torch.eye(a_h.shape[0], dtype=a_h.dtype,
                                      device=a_h.device)
        W_new = solve_nnls(a_h, B_w, W, L1=L1_w, L2=L2_w,
                           update_mask=gene_ne, **kw)
        W_new, d = scale_columns(W_new)
        tol = pmax(mesh, cor_distance(W_new[:genes_true], W[:genes_true]))
        return W_new, H_loc, d, tol

    def _masked(W, H_loc, seed, L1, L2, sweep_cap=None,
                max_sweeps: int = CD_MAX_SWEEPS):
        kw = dict(L1=L1, L2=L2, sweep_cap=sweep_cap, max_sweeps=max_sweeps)
        k = W.shape[1]
        iu = triu_pairs(k)
        M = _rank_mask(data, seed, inv_density)      # (cells_local, genes)

        # h-update over the rank's cell blocks
        a_full = gram(W)
        Pw = packed_outer_products(W, iu)
        Hs = []
        for start in range(0, cells_local, cell_block):
            blk = slice(start, start + cell_block)
            m = M[blk]                                   # (blk, genes_pad)
            B = torch.where(m.T, 0.0, A_loc[:, blk]).T @ W
            Hs.append(solve_nnls_packed_t(
                a_full, mask_dot_t(Pw, m, 1), iu, B, H_loc[blk],
                update_mask=ne_loc[blk], **kw))
        H_new = torch.cat(Hs)
        d = psum(mesh, H_new.sum(dim=0)) + 1e-15
        H_new = H_new / d[None, :]

        # w-update over gene blocks, the partials summed over the ranks
        a_h = _psum_gram(mesh, H_new)
        Ph = packed_outer_products(H_new, iu)          # (cells_local, np)
        Ws = []
        for start in range(0, genes_pad, gene_block):
            blk = slice(start, start + gene_block)
            m = M[:, blk].T                              # (blk, cells_local)
            B = torch.where(m, 0.0, A_loc[blk]) @ H_new
            packed_t = mask_dot_t(Ph, m, 1)
            psum(mesh, B, packed_t)
            Ws.append(solve_nnls_packed_t(
                a_h, packed_t, iu, B, W[blk], update_mask=gene_ne[blk],
                **kw))
        W_new, d = scale_columns(torch.cat(Ws))
        tol = pmax(mesh, cor_distance(W_new[:genes_true], W[:genes_true]))
        return W_new, H_new, d, tol

    def _mse(W, d, H_loc, seed):
        """Held-out test MSE over the rank's cell blocks, summed over the
        ranks, over the true cells."""
        M = _rank_mask(data, seed, inv_density)
        Wd = W * d[None, :]
        acc = torch.zeros((), dtype=W.dtype, device=W.device)
        for start in range(0, cells_local, cell_block):
            blk = slice(start, start + cell_block)
            m = M[blk]
            pred = H_loc[blk] @ Wd.T
            s = torch.where(m, torch.square(pred - A_loc[:, blk].T),
                            0.0).sum(dim=1)
            n = m.sum(dim=1)
            acc = acc + torch.where(n > 0, s / n.clamp(min=1), 0.0).sum()
        return psum(mesh, acc) / cells_true

    return _plain, _masked, _mse


def sharded_nmf_fit(A: np.ndarray, k: int, mesh=None, tol: float = 1e-4,
                    maxit: int = 100, L1: float = 0.01, L2: float = 0.0,
                    seed: int = 0, masked: bool = False,
                    inv_density: int = 20, mask_seed: int = 0,
                    verbose: bool = False, w_init=None, device=None):
    """Fit NMF with the cells split over the mesh's ranks. Returns the JAX
    dict (w, d, h, tol_trace, and test_mse when masked), the whole model on
    every rank (H gathered over the ranks).

    Every rank calls this with the same arguments and the whole ``A``.
    ``mesh=None`` is one device with no collective (a world of one gives
    its bits); ``device`` defaults to the rank's (``rank_device``). Without
    ``w_init`` W is drawn from a ``torch.Generator`` seeded with ``seed``
    (another W than the JAX package's threefry draw)."""
    from singlet_tpu_torch.solvers.als import _padded, init_w, logged_fit_loop

    mesh = check_mesh(mesh)
    data = shard_data(A, mesh, device=device)
    plain, masked_step, mse = build_sharded_steps(data, int(inv_density))
    k = int(k)
    dev = data.device
    if w_init is None:
        W = init_w(k, data.genes_pad, data.genes_true, seed, device=dev)
    else:
        W = _padded(np.asarray(w_init, np.float32), data.genes_pad, k, dev)
    H = torch.zeros((data.cells_local, k), dtype=torch.float32, device=dev)
    sp_ = seed_pair(mask_seed)
    settings = SweepSettings.from_env()
    L1, L2 = float(L1), float(L2)

    if masked:
        def step(W, H, cap):
            return masked_step(W, H, sp_, L1, L2, sweep_cap=cap,
                               max_sweeps=settings.max_sweeps)
    else:
        def step(W, H, cap):
            return plain(W, H, L1, L1, L2, L2, sweep_cap=cap,
                         max_sweeps=settings.max_sweeps)

    W, H, d, traces = logged_fit_loop(
        "sharded", step, W, H, tol, maxit, settings, masked=bool(masked),
        verbose=verbose, genes=int(data.genes_true),
        cells=int(data.cells_true), n_devices=data.n_dev)
    H_all = all_gather_cells(mesh, H)
    out = dict(w=W[:data.genes_true].cpu().numpy(), d=d.cpu().numpy(),
               h=H_all[:data.cells_true].T.cpu().numpy(), tol_trace=traces)
    if masked:
        out["test_mse"] = float(mse(W, d, H, sp_))
    return out

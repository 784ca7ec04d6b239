"""The process runtime and per-rank ingest of the cell mesh.

Port of ``singlet_tpu/parallel/multihost.py`` on ``torch.distributed``,
one process per device:

  * ``initialize()``: joins the world, once per process. Under ``torchrun``
    it reads ``env://`` (``RANK``, ``WORLD_SIZE``, ``MASTER_ADDR``,
    ``MASTER_PORT``); elsewhere it takes the coordinator address, the world
    size and this process's rank; with one process and no coordinator it
    does nothing, as the JAX one. NCCL on a card, gloo on the CPU, unless
    ``backend`` says otherwise (two ranks sharing one card run over gloo:
    NCCL refuses two ranks on one device);
  * ``global_mesh()``: the 1-D ``"cells"`` mesh over every rank;
  * ``process_cell_range()``: the padded cells a rank owns, one device per
    process;
  * ``shard_cells_from_local()``: each rank contributes only its own
    columns, and no rank ever holds the whole matrix (the reference's
    file-staging workflow, reference:R/run_nmf.R:79-107, without it).

The test mask needs no coordination: it is keyed by global (cell, gene)
ids, so every rank derives its own test set (reference:src/singlet.cpp:
30-64). A rank's device is ``cuda:{LOCAL_RANK}`` unless the caller names
one; a ``LOCAL_RANK`` past the host's cards raises.
"""

from __future__ import annotations

import os
from typing import Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

from singlet_tpu_torch.device import resolve_device
from singlet_tpu_torch.parallel.collectives import rank_of, world_of
from singlet_tpu_torch.parallel.sharded import (AXIS, ShardedData,
                                                _dense_data, _local_index,
                                                cell_geometry, check_mesh,
                                                make_mesh, rank_device)

__all__ = ["initialize", "global_mesh", "process_cell_range",
           "shard_cells_from_local"]


def initialize(coordinator_address: Optional[str] = None,
               num_processes: Optional[int] = None,
               process_id: Optional[int] = None,
               backend: Optional[str] = None, device=None) -> None:
    """Join the world (idempotent; a no-op for one process).

    ``coordinator_address`` is ``host:port`` (TCP), or an init-method URL
    (``tcp://...``, ``file://...``); with none given and ``WORLD_SIZE`` in
    the environment (``torchrun``) it reads ``env://``. ``backend``
    defaults to NCCL for a card and gloo for the CPU; ``device`` (default
    ``"cuda"``) is the rank's, made current on a card."""
    if dist.is_initialized():
        return
    env_world = int(os.environ.get("WORLD_SIZE", "1"))
    if coordinator_address is None and num_processes in (None, 1) \
            and process_id in (None, 0) and env_world == 1:
        return
    if coordinator_address is None:
        init_method = "env://"
        num_processes = env_world if num_processes is None else num_processes
        process_id = int(os.environ.get("RANK", process_id or 0))
    else:
        init_method = (coordinator_address if "://" in coordinator_address
                       else f"tcp://{coordinator_address}")
    process_id = int(process_id or 0)
    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = resolve_device(torch.device("cuda", _local_index(process_id)))
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    if backend is None:
        backend = "nccl" if dev.type == "cuda" else "gloo"
    dist.init_process_group(backend=backend, init_method=init_method,
                            world_size=int(num_processes),
                            rank=process_id)


def global_mesh(axis: str = AXIS, device=None):
    """The 1-D mesh over every rank of the world, in rank order (a world of
    one when none was initialized)."""
    if axis != AXIS:
        raise ValueError(f"the cell mesh's dimension is named {AXIS!r}")
    return make_mesh(device=device)


def process_cell_range(genes: int, cells: int, mesh,
                       process_id: Optional[int] = None,
                       cell_block: int = 1024,
                       gene_block: int = 2048) -> Tuple[int, int]:
    """[start, stop) of the padded cell axis owned by a process, one device
    a process: the ranks split it evenly in rank order. Cells >= ``cells``
    inside the range are padding the rank leaves zero."""
    mesh = check_mesh(mesh)
    pid = rank_of(mesh) if process_id is None else int(process_id)
    n_dev = world_of(mesh)
    _, cells_pad, _, _ = cell_geometry(genes, cells, n_dev, cell_block,
                                       gene_block)
    per_dev = cells_pad // n_dev
    return pid * per_dev, (pid + 1) * per_dev


def shard_cells_from_local(local_cols: np.ndarray, cells_true: int, mesh,
                           cell_block: int = 1024, gene_block: int = 2048,
                           device=None) -> ShardedData:
    """The rank's ShardedData from its own (genes, owned true columns)
    slice: the columns of ``process_cell_range(...)`` up to ``cells_true``,
    zero-padded here to the range. ``gene_nonempty`` is OR'ed over the
    ranks. The same data ``shard_data`` gives the rank, without any rank
    holding the whole matrix."""
    mesh = check_mesh(mesh)
    device = rank_device(mesh, device)
    local_cols = np.asarray(local_cols, np.float32)
    genes = local_cols.shape[0]
    geometry = cell_geometry(genes, cells_true, world_of(mesh), cell_block,
                             gene_block)
    genes_pad = geometry[0]
    start, stop = process_cell_range(genes, cells_true, mesh,
                                     cell_block=cell_block,
                                     gene_block=gene_block)
    # the rank must supply exactly its owned true columns: anything less
    # would silently zero-fill real cells, anything more won't fit
    expected = max(0, min(stop, cells_true) - start)
    if local_cols.shape[1] != expected:
        raise ValueError(
            f"rank {rank_of(mesh)} owns padded cell range [{start}, {stop}) "
            f"= {expected} true columns, got {local_cols.shape[1]}")
    buf = np.zeros((genes_pad, stop - start), np.float32)
    buf[:genes, :expected] = local_cols
    ne = (np.abs(buf) > 0).any(axis=0)
    return _dense_data(buf, ne, (local_cols != 0).any(axis=1), mesh, device,
                       genes, cells_true, geometry, or_over_ranks=True)

"""The collectives of the cell mesh, over ``torch.distributed``.

The port's own module, with no JAX twin: the JAX engines reduce inside
``shard_map`` with ``jax.lax.psum`` and ``all_gather``, and the port runs
one process per device, so its engines call these helpers between their
kernels. Every helper takes the mesh (a 1-D ``DeviceMesh`` named
``"cells"``, ``parallel/sharded.py`` ``make_mesh``) or None, which means
one device and no collective at all.

  * ``psum``: an in-place ``all_reduce`` SUM of one or more tensors (more
    than one go as one flat buffer, one call);
  * ``pmax``: the same with MAX, for the one value every rank's loop reads
    (the tol of the stop test and the sweep cap);
  * ``all_gather_cells``: the tiled ``all_gather`` along the cell axis
    (dim 0), ranks in order;
  * ``allgather_max``: the elementwise max of a few host ints (the JAX
    ``_allgather_max``);
  * ``any_over_ranks``: a bool vector OR'ed over ranks (MAX over uint8);
  * ``barrier``: every rank waits for every other (a one-element SUM).

The transport is chosen by the group's backend, never by catching an
error. The tensors go to the collective where they are: NCCL takes CUDA
tensors, and gloo takes CPU tensors and also CUDA tensors, which it copies
through host memory itself (``chip_smoke.py`` phase 17 probes all_reduce,
all_gather, all_gather_into_tensor and reduce_scatter_tensor on an H100:
gloo takes each); two ranks sharing one card run over gloo, because NCCL
refuses two ranks on one device. Only the small tensors of host values are
placed by backend (``_host_device``: the CPU for gloo, the card for NCCL).
``COUNTS`` counts the calls and the bytes each rank sends into them; with
``TIMED`` on, it also sums their time (CUDA events around each call on a
card, the host clock on the CPU), waits for the other ranks included.
"""

from __future__ import annotations

import time
from typing import Iterable, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

__all__ = ["psum", "pmax", "all_gather_cells", "allgather_max",
           "any_over_ranks", "barrier", "world_of", "rank_of", "group_of",
           "backend_of", "COUNTS", "reset_counts", "counts"]

# calls, bytes sent in, and (with TIMED) milliseconds of the collectives of
# this process since the last reset_counts()
COUNTS = {"calls": 0, "bytes": 0}
TIMED = False
_EVENTS = []
_HOST_MS = []


def reset_counts(timed: Optional[bool] = None) -> None:
    """Set the counts to 0; ``timed`` turns the timing on or off."""
    global TIMED
    COUNTS.update(calls=0, bytes=0)
    _EVENTS.clear()
    _HOST_MS.clear()
    if timed is not None:
        TIMED = bool(timed)


def counts() -> dict:
    """{"calls", "bytes", "ms"}: the counts since the last reset, with the
    summed time of the timed calls (synchronizes the card)."""
    ms = sum(_HOST_MS)
    if _EVENTS:
        torch.cuda.synchronize()
        ms += sum(a.elapsed_time(b) for a, b in _EVENTS)
    return dict(COUNTS, ms=ms)


def group_of(mesh):
    """The process group of the mesh's ``"cells"`` dimension."""
    return mesh.get_group("cells")


def backend_of(mesh) -> str:
    return str(dist.get_backend(group_of(mesh)))


def world_of(mesh) -> int:
    """The number of ranks of the mesh (1 without one)."""
    return 1 if mesh is None else int(mesh.size())


def rank_of(mesh) -> int:
    """This process's rank on the mesh (0 without one)."""
    return 0 if mesh is None else int(dist.get_rank(group_of(mesh)))


class _Timed:
    """Counts one collective call and, with TIMED, times it."""

    def __init__(self, nbytes: int, on_card: bool) -> None:
        COUNTS["calls"] += 1
        COUNTS["bytes"] += int(nbytes)
        self.on_card = on_card

    def __enter__(self):
        if TIMED:
            if self.on_card:
                self.ev = (torch.cuda.Event(enable_timing=True),
                           torch.cuda.Event(enable_timing=True))
                self.ev[0].record()
            else:
                self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc) -> None:
        if TIMED:
            if self.on_card:
                self.ev[1].record()
                _EVENTS.append(self.ev)
            else:
                _HOST_MS.append((time.perf_counter() - self.t0) * 1e3)


def _all_reduce(mesh, flat: torch.Tensor, op) -> None:
    """In-place all_reduce of one contiguous tensor."""
    with _Timed(flat.numel() * flat.element_size(), flat.is_cuda):
        dist.all_reduce(flat, op=op, group=group_of(mesh))


def _reduce(mesh, tensors: Sequence[torch.Tensor], op) -> None:
    if mesh is None:
        return
    if len(tensors) == 1 and tensors[0].is_contiguous():
        _all_reduce(mesh, tensors[0], op)
        return
    flat = torch.cat([t.reshape(-1) for t in tensors])
    _all_reduce(mesh, flat, op)
    off = 0
    for t in tensors:
        t.copy_(flat[off:off + t.numel()].view(t.shape))
        off += t.numel()


def psum(mesh, *tensors: torch.Tensor):
    """SUM every tensor over the mesh's ranks, in place (one call for all
    of them; the JAX engines' ``jax.lax.psum``). Returns the tensor, or the
    tuple of them."""
    _reduce(mesh, tensors, dist.ReduceOp.SUM)
    return tensors[0] if len(tensors) == 1 else tensors


def pmax(mesh, t: torch.Tensor) -> torch.Tensor:
    """MAX of ``t`` over the mesh's ranks, in place: the value every rank's
    loop decision reads, so that the ranks' loops cannot part."""
    _reduce(mesh, (t,), dist.ReduceOp.MAX)
    return t


def all_gather_cells(mesh, x: torch.Tensor) -> torch.Tensor:
    """The ranks' ``x`` (cells_local, ...) concatenated along dim 0 in rank
    order, on every rank: the tiled ``all_gather`` of the JAX engines."""
    if mesh is None:
        return x
    x = x.contiguous()
    parts = [torch.empty_like(x) for _ in range(world_of(mesh))]
    with _Timed(x.numel() * x.element_size(), x.is_cuda):
        dist.all_gather(parts, x, group=group_of(mesh))
    return torch.cat(parts)


def _host_device(mesh) -> torch.device:
    """Where a small tensor of host values lives for the mesh's backend:
    the CPU for gloo, the rank's card for NCCL."""
    if backend_of(mesh) == "gloo":
        return torch.device("cpu")
    return torch.device("cuda", torch.cuda.current_device())


def allgather_max(mesh, vals: Iterable[int]) -> Tuple[int, ...]:
    """Elementwise max of a few host ints over the ranks (the JAX
    ``_allgather_max``)."""
    vals = tuple(int(v) for v in vals)
    if mesh is None:
        return vals
    t = torch.tensor(vals, dtype=torch.int64, device=_host_device(mesh))
    _all_reduce(mesh, t, dist.ReduceOp.MAX)
    return tuple(int(v) for v in t.tolist())


def any_over_ranks(mesh, flags: torch.Tensor) -> torch.Tensor:
    """A bool vector OR'ed over the ranks (MAX over uint8), on the flags'
    device."""
    if mesh is None:
        return flags
    t = flags.to(torch.uint8)
    if backend_of(mesh) == "nccl":
        t = t.to(_host_device(mesh))
    _all_reduce(mesh, t, dist.ReduceOp.MAX)
    return t.to(device=flags.device, dtype=torch.bool)


def barrier(mesh) -> None:
    """Every rank of the mesh waits here for every other."""
    if mesh is None:
        return
    t = torch.zeros(1, dtype=torch.int32, device=_host_device(mesh))
    _all_reduce(mesh, t, dist.ReduceOp.SUM)
    if t.is_cuda:
        torch.cuda.synchronize(t.device)

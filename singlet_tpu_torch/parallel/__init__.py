"""The cell mesh, its engines and its ingest: the twin of
``singlet_tpu/parallel``.

- ``sharded``: the 1-D ``"cells"`` mesh (``make_mesh``) and the dense mesh
  engine (``shard_data``, ``sharded_nmf_fit``);
- ``sharded_ell``: the blocked-ELL engine, on one device or on the mesh;
- ``multihost``: the process runtime (``initialize``, ``global_mesh``) and
  per-rank ingest;
- ``collectives``: the port's own reductions and gathers over
  ``torch.distributed`` (NCCL on a card, gloo on the CPU), which the JAX
  engines get from ``shard_map``.

The port runs one process per device, as ``torchrun`` starts them: the JAX
package's single-process mesh of N devices is here a world of N ranks,
each holding its own cells, with a ``DeviceMesh`` over them. A world of
one (``make_mesh()`` with no process group) gives the bits of the engines
with no mesh.
"""

from singlet_tpu_torch.parallel.multihost import (global_mesh, initialize,
                                                  process_cell_range,
                                                  shard_cells_from_local)
from singlet_tpu_torch.parallel.sharded import (make_mesh, shard_data,
                                                sharded_nmf_fit)
from singlet_tpu_torch.parallel.sharded_ell import (ShardedEllEngine,
                                                    sharded_ell_nmf_fit)

__all__ = [
    "initialize",
    "global_mesh",
    "process_cell_range",
    "shard_cells_from_local",
    "make_mesh",
    "shard_data",
    "sharded_nmf_fit",
    "ShardedEllEngine",
    "sharded_ell_nmf_fit",
]

"""Operand kind ``dense_uniform``: the ``bench.py`` operand (each entry
kept with probability ``density``, kept values U(low, high)), as
``chip_smoke._bench_operand`` defines it, drawn from a ``torch.Generator``
on the device in two calls and handed to the program as the dense
provider pair of ``make_dense_providers`` (the matrix and its transpose,
in blocks of ``cell_block`` cells and ``gene_block`` genes).

Configuration keys: ``genes``, ``cells``, ``density``, ``low``, ``high``,
``gene_block``, ``cell_block``.
"""

from __future__ import annotations

import torch

from portbench import reference


def dense_uniform(genes: int, cells: int, density: float, low: float,
                  high: float, seed: int, device):
    """(genes, cells) float32: each entry kept with probability
    ``density``, kept values U(low, high), zeros elsewhere."""
    gen = torch.Generator(device=device).manual_seed(int(seed))
    keep = torch.rand((genes, cells), generator=gen, device=device) < density
    vals = torch.rand((genes, cells), generator=gen, device=device)
    vals.mul_(high - low).add_(low)
    return torch.where(keep, vals, 0.0)


def build(cfg, seed: int, device):
    """((A, At) dense providers, the reference's ``DenseOperand``)."""
    from singlet_tpu_torch.solvers.als import pick_block
    from singlet_tpu_torch.sparse.matrix import DenseMatrix

    genes, cells = int(cfg["genes"]), int(cfg["cells"])
    cb = pick_block(cells, int(cfg["cell_block"]))
    gb = pick_block(genes, int(cfg["gene_block"]))
    A = dense_uniform(genes, cells, float(cfg["density"]), float(cfg["low"]),
                      float(cfg["high"]), seed, device)
    data = torch.zeros((-(-genes // gb) * gb, -(-cells // cb) * cb),
                       dtype=torch.float32, device=device)
    data[:genes, :cells] = A
    del A
    op = reference.DenseOperand(data, genes, cells)
    Ap = DenseMatrix(data=data, nonempty=op.cell_nonempty, rows_true=genes,
                     cols_true=cells, cols_are_cells=True, block=cb)
    Atp = DenseMatrix(data=data.T, nonempty=op.gene_nonempty,
                      rows_true=cells, cols_true=genes, cols_are_cells=False,
                      block=gb, mask_cache=Ap.mask_cache)
    return (Ap, Atp), op

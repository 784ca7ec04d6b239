"""Operand kind ``bell_closed_form``: the closed-form blocked-ELL operand
of ``benchmarks/largescale.py`` (``synth_bell_planes``), as
``chip_smoke.synth_bell_planes_torch`` makes it on the card, handed to the
program as its ELL engine (``ShardedEllEngine`` on one card).

Per gene block each cell holds ``nnz_per_cell // n_gb`` jittered, evenly
spaced genes with hashed values in [0.1, 1.1). The seed salts both
hashes; seed 0 gives the original operand bit for bit. A copy, kept here
so that the yardstick does not move with the program.

Configuration keys: ``genes``, ``cells``, ``nnz_per_cell``,
``gene_block``, ``cell_block`` (whole blocks of both).
"""

from __future__ import annotations

import numpy as np
import torch

from portbench import reference

M32 = 0xFFFFFFFF


def mul32(h, m: int):
    """(h * m) mod 2^32 for int64 h in [0, 2^32) and a constant m < 2^32,
    without int64 overflow: m is split into 16-bit halves."""
    lo, hi = m & 0xFFFF, m >> 16
    return (h * lo + (((h * hi) & 0xFFFF) << 16)) & M32


def salts(seed: int):
    """The two 32-bit salts of the closed-form operand; both 0 at seed 0."""
    return (int(seed) * 0x9E3779B9) & M32, (int(seed) * 0x85EBCA6B) & M32


def hash_val(c, g, salt: int = 0):
    """``benchmarks/largescale.py`` ``_hash_val`` on int64 tensors, salted:
    a value in [0.1, 1.1) from (cell, gene)."""
    h = (mul32(c, 2654435761) + mul32(g, 40503) + 0x9E37 + salt) & M32
    h = h ^ (h >> 16)
    h = mul32(h, 2246822519)
    return (h >> 16).float() / 65536.0 + float(np.float32(0.1))


def plane_width(genes: int, nnz_per_cell: int, gene_block: int) -> int:
    per_gb = max(1, nnz_per_cell // (genes // gene_block))
    return ((per_gb + 7) // 8) * 8


def bell_planes(genes: int, cells: int, nnz_per_cell: int, gene_block: int,
                seed: int, device, chunk: int = 32768):
    """(b_li int32, b_val float32) planes (n_gb * width, cells) and the
    width: the closed-form operand with the seed's salts."""
    s_val, s_jit = salts(seed)
    n_gb = genes // gene_block
    per_gb = max(1, nnz_per_cell // n_gb)
    width = plane_width(genes, nnz_per_cell, gene_block)
    gb = torch.arange(n_gb, device=device)[:, None, None]
    w = torch.arange(width, device=device)[None, :, None]
    live = w < per_gb
    ws = torch.clamp(w, max=per_gb - 1)
    base = (ws * gene_block) // per_gb
    gap = torch.clamp(((ws + 1) * gene_block) // per_gb - base, min=1)
    mix = mul32(gb * 131 + ws, 40503)
    b_li = torch.empty((n_gb * width, cells), dtype=torch.int32,
                       device=device)
    b_val = torch.empty((n_gb * width, cells), dtype=torch.float32,
                        device=device)
    for c0 in range(0, cells, chunk):
        c = torch.arange(c0, min(c0 + chunk, cells),
                         device=device)[None, None, :]
        h = ((mul32(c, 2654435761) + mix + s_jit) & M32) & 0x7FFFFFFF
        li = torch.where(live, base + h % gap, -1)
        val = torch.where(live, hash_val(
            c, gb * gene_block + torch.clamp(li, min=0), s_val), 0.0)
        b_li[:, c0:c0 + c.shape[2]] = li.reshape(n_gb * width, -1)
        b_val[:, c0:c0 + c.shape[2]] = val.reshape(n_gb * width, -1)
    return b_li, b_val, width


def build(cfg, seed: int, device):
    """(the ELL engine, the reference's ``EllOperand``) of ``cfg``."""
    from singlet_tpu_torch.parallel.sharded_ell import (ShardedEllData,
                                                        ShardedEllEngine)

    genes, cells = int(cfg["genes"]), int(cfg["cells"])
    gb, cb = int(cfg["gene_block"]), int(cfg["cell_block"])
    if genes % gb or cells % cb:
        raise ValueError("the closed-form operand takes whole gene and "
                         "cell blocks")
    b_li, b_val, width = bell_planes(genes, cells, int(cfg["nnz_per_cell"]),
                                     gb, seed, device)
    op = reference.EllOperand(b_li, b_val, gb, genes, cells, genes)
    data = ShardedEllData(
        b_li=b_li, b_val=b_val, b_width=width, nonempty=op.cell_nonempty,
        gene_nonempty=op.gene_nonempty, device=torch.device(device),
        genes_true=genes, cells_true=cells, genes_pad=genes,
        cells_pad=cells, cell_block=cb, gene_block=gb)
    return ShardedEllEngine(None, data=data), op

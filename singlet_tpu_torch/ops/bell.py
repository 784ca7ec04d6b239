"""Blocked-ELL SpMM: the two sparse products of the ELL engine and the
fused test MSE, and their dispatchers.

Twin of ``singlet_tpu/ops/pallas_bell.py`` ``bell_spmm`` / ``bell_spmm_t``
(kernels B3 and B4), ``bell_spmm_bits`` / ``bell_spmm_t_bits`` (B5 and B6:
the same products with the keep factor read from the packed test-mask
words of ``ops/maskbits.py`` instead of hashed) and ``bell_mse_bits`` (B7:
per-cell held-out squared-error sums and counts). The planes are 2-D ``(n_gb * width, cells)``: row
``gb * width + w`` holds slot w of gene block gb, as LOCAL gene indices
(pad -1) and values (pad 0), cells contiguous.

  * ``bell_spmm``   B  = sum_gb densify(li[gb], lv[gb])[* keep] @ W[gb]
                    (cells, k)
  * ``bell_spmm_t`` Bw = concat_gb densify(li[gb], lv[gb])[* keep]^T @ H
                    (n_gb * gene_block, k)

With a ``seed`` the masked-CV keep factor ``1 - mask(seed, cell, gene)``
(``ops/rngmask.py``) multiplies every entry; cell ids are global,
``cell_offset`` plus the local column. Padded cells and genes have no
nonzeros, so no validity clamp is needed.

The words of B5-B7 are the natural (cells, n_t * gene_block) layout,
sliced to the planes' cells; B7 returns (2, cells), rows s and n (the JAX
kernel's rows 2-7 are TPU sublane padding).

The plain versions keep the XLA tile formulation of the JAX package's
``_make_spmm_fns`` (``parallel/sharded_ell.py``): each gene block's window
is densified to a (cells, gene_block) tile by ``_bell_tile`` and multiplied
densely. The dispatchers send CUDA tensors to the hand-written kernels of
``ops/bell_cuda.py`` and CPU tensors to the plain versions.
"""

from __future__ import annotations

from typing import Optional

import torch

from singlet_tpu_torch.ops.maskbits import unpack_all, unpack_gene_block
from singlet_tpu_torch.ops.rngmask import mask_block

# calls of the plain versions (the kernels count their own launches)
PLAIN_CALLS = 0

# plane width above which _bell_tile switches from the unrolled FMA chain
# to the one-shot compare-and-reduce (as in the JAX package, where the
# unroll bounds traced HLO size)
_BELL_TILE_UNROLL_MAX_WIDTH = 128


def _bell_tile(li: torch.Tensor, lv: torch.Tensor,
               gene_block: int) -> torch.Tensor:
    """(width, block) local-index window -> dense (block, gene_block) tile
    by a multiply-compare-sum (pad slots, li = -1 / lv = 0, add exact
    zeros). Narrow planes sum the slots one by one; wide planes
    (width > 128) compare all slots at once."""
    iota = torch.arange(gene_block, dtype=li.dtype, device=li.device)[None, :]
    if li.shape[0] > _BELL_TILE_UNROLL_MAX_WIDTH:
        onehot = (li[:, :, None] == iota[None]).to(lv.dtype)
        return torch.sum(lv[:, :, None] * onehot, dim=0)
    tile = torch.zeros((li.shape[1], gene_block), dtype=lv.dtype,
                       device=lv.device)
    for w in range(li.shape[0]):    # accumulates in place (eager torch)
        tile.add_(lv[w][:, None] * (li[w][:, None] == iota))
    return tile


def _keep(seed, cell_offset: int, cells: int, g0: int, gene_block: int,
          inv_density: int, device) -> torch.Tensor:
    """1 - test mask over one gene block's (cells, gene_block) grid."""
    ids = torch.arange(cell_offset, cell_offset + cells, device=device)
    gene_ids = torch.arange(g0, g0 + gene_block, device=device)
    return 1.0 - mask_block(seed, ids, gene_ids, inv_density).to(
        torch.float32)


def _gb_rows(n_rows: int, n_gb: int, gb: int) -> slice:
    width = n_rows // n_gb
    return slice(gb * width, (gb + 1) * width)


def bell_spmm_plain(b_li, b_val, W, seed=None, cell_offset: int = 0, *,
                    gene_block: int, inv_density: int = 20) -> torch.Tensor:
    """The plain version of kernel B3: (cells, k) float32."""
    global PLAIN_CALLS
    PLAIN_CALLS += 1
    n_gb = W.shape[0] // gene_block
    cells = b_li.shape[1]
    B = torch.zeros((cells, W.shape[1]), dtype=W.dtype, device=W.device)
    for gb in range(n_gb):
        sl = _gb_rows(b_li.shape[0], n_gb, gb)
        tile = _bell_tile(b_li[sl], b_val[sl], gene_block)
        g0 = gb * gene_block
        if seed is not None:
            tile = tile * _keep(seed, cell_offset, cells, g0, gene_block,
                                inv_density, W.device)
        B = B + tile @ W[g0:g0 + gene_block]
    return B


def bell_spmm_t_plain(b_li, b_val, H, seed=None, cell_offset: int = 0, *,
                      gene_block: int, n_gb: int,
                      inv_density: int = 20) -> torch.Tensor:
    """The plain version of kernel B4: (n_gb * gene_block, k) float32."""
    global PLAIN_CALLS
    PLAIN_CALLS += 1
    cells = b_li.shape[1]
    parts = []
    for gb in range(n_gb):
        sl = _gb_rows(b_li.shape[0], n_gb, gb)
        tile = _bell_tile(b_li[sl], b_val[sl], gene_block)
        if seed is not None:
            tile = tile * _keep(seed, cell_offset, cells, gb * gene_block,
                                gene_block, inv_density, H.device)
        parts.append(tile.T @ H)
    return torch.cat(parts, dim=0)


def _keep_bits(words, gb: int, gene_block: int) -> torch.Tensor:
    """1 - test mask of one gene block, (cells, gene_block), from words."""
    return 1.0 - unpack_gene_block(words, gb, gene_block).to(torch.float32)


def bell_spmm_bits_plain(b_li, b_val, W, words, *,
                         gene_block: int) -> torch.Tensor:
    """The plain version of kernel B5: (cells, k) float32."""
    global PLAIN_CALLS
    PLAIN_CALLS += 1
    n_gb = W.shape[0] // gene_block
    B = torch.zeros((b_li.shape[1], W.shape[1]), dtype=W.dtype,
                    device=W.device)
    for gb in range(n_gb):
        sl = _gb_rows(b_li.shape[0], n_gb, gb)
        tile = _bell_tile(b_li[sl], b_val[sl], gene_block)
        tile = tile * _keep_bits(words, gb, gene_block)
        g0 = gb * gene_block
        B = B + tile @ W[g0:g0 + gene_block]
    return B


def bell_spmm_t_bits_plain(b_li, b_val, H, words, *, gene_block: int,
                           n_gb: int) -> torch.Tensor:
    """The plain version of kernel B6: (n_gb * gene_block, k) float32."""
    global PLAIN_CALLS
    PLAIN_CALLS += 1
    parts = []
    for gb in range(n_gb):
        sl = _gb_rows(b_li.shape[0], n_gb, gb)
        tile = _bell_tile(b_li[sl], b_val[sl], gene_block)
        tile = tile * _keep_bits(words, gb, gene_block)
        parts.append(tile.T @ H)
    return torch.cat(parts, dim=0)


# cells per pass of the plain test MSE, which densifies its cells
_MSE_PLAIN_CELLS = 2048


def bell_mse_bits_plain(b_li, b_val, words, Wd, H, *,
                        gene_block: int) -> torch.Tensor:
    """The plain version of kernel B7: (2, cells) float32, row 0 the sum of
    squared errors of each cell's held-out genes and row 1 their count.
    Densifies and predicts every entry, ``_MSE_PLAIN_CELLS`` cells at a
    time."""
    global PLAIN_CALLS
    PLAIN_CALLS += 1
    n_gb = Wd.shape[0] // gene_block
    cells = b_li.shape[1]
    out = torch.zeros((2, cells), dtype=torch.float32, device=Wd.device)
    for c0 in range(0, cells, _MSE_PLAIN_CELLS):
        sl = slice(c0, c0 + _MSE_PLAIN_CELLS)
        m = unpack_all(words[sl], Wd.shape[0], gene_block)
        dense = densify_planes(b_li[:, sl], b_val[:, sl], gene_block, n_gb)
        diff2 = torch.square(H[sl] @ Wd.T - dense)
        out[0, sl] = torch.where(m, diff2, 0.0).sum(dim=1)
        out[1, sl] = m.sum(dim=1).to(torch.float32)
    return out


def bell_spmm(b_li, b_val, W, seed: Optional[torch.Tensor] = None,
              cell_offset: int = 0, *, gene_block: int,
              inv_density: int = 20) -> torch.Tensor:
    """Dispatcher of B3: kernel B3 for CUDA tensors, the plain version on
    the CPU. ``seed`` (``rngmask.seed_pair``) selects the masked form."""
    if W.device.type == "cuda":
        from singlet_tpu_torch.ops import bell_cuda

        return bell_cuda.bell_spmm_cuda(
            b_li, b_val, W, seed, cell_offset, gene_block=gene_block,
            inv_density=inv_density)
    return bell_spmm_plain(b_li, b_val, W, seed, cell_offset,
                           gene_block=gene_block, inv_density=inv_density)


def bell_spmm_t(b_li, b_val, H, seed: Optional[torch.Tensor] = None,
                cell_offset: int = 0, *, gene_block: int, n_gb: int,
                inv_density: int = 20) -> torch.Tensor:
    """Dispatcher of B4: kernel B4 for CUDA tensors, the plain version on
    the CPU."""
    if H.device.type == "cuda":
        from singlet_tpu_torch.ops import bell_cuda

        return bell_cuda.bell_spmm_t_cuda(
            b_li, b_val, H, seed, cell_offset, gene_block=gene_block,
            n_gb=n_gb, inv_density=inv_density)
    return bell_spmm_t_plain(b_li, b_val, H, seed, cell_offset,
                             gene_block=gene_block, n_gb=n_gb,
                             inv_density=inv_density)


def densify_planes(b_li, b_val, gene_block: int, n_gb: int) -> torch.Tensor:
    """The dense (cells, n_gb * gene_block) operand of a cell block's planes,
    by one scatter-add along the genes (the test-MSE path: no kernel stands
    behind it). Pad slots add their zero to a spare column, so no live-slot
    selection (a host sync) is needed."""
    cells = b_li.shape[1]
    width = b_li.shape[0] // n_gb
    genes = n_gb * gene_block
    gb = torch.arange(n_gb, device=b_li.device).repeat_interleave(width)
    gene = torch.where(b_li >= 0,
                       b_li.to(torch.int64) + (gb * gene_block)[:, None],
                       genes)
    dense = torch.zeros((cells, genes + 1), dtype=b_val.dtype,
                        device=b_val.device)
    dense.scatter_add_(1, gene.T, b_val.T)
    return dense[:, :genes]


def bell_spmm_bits(b_li, b_val, W, words, *, gene_block: int) -> torch.Tensor:
    """Dispatcher of B5: kernel B5 for CUDA tensors, the plain version on
    the CPU."""
    if W.device.type == "cuda":
        from singlet_tpu_torch.ops import bell_cuda

        return bell_cuda.bell_spmm_bits_cuda(b_li, b_val, W, words,
                                             gene_block=gene_block)
    return bell_spmm_bits_plain(b_li, b_val, W, words, gene_block=gene_block)


def bell_spmm_t_bits(b_li, b_val, H, words, *, gene_block: int,
                     n_gb: int) -> torch.Tensor:
    """Dispatcher of B6: kernel B6 for CUDA tensors, the plain version on
    the CPU."""
    if H.device.type == "cuda":
        from singlet_tpu_torch.ops import bell_cuda

        return bell_cuda.bell_spmm_t_bits_cuda(b_li, b_val, H, words,
                                               gene_block=gene_block,
                                               n_gb=n_gb)
    return bell_spmm_t_bits_plain(b_li, b_val, H, words,
                                  gene_block=gene_block, n_gb=n_gb)


def bell_mse_bits(b_li, b_val, words, Wd, H, *,
                  gene_block: int) -> torch.Tensor:
    """Dispatcher of B7: kernel B7 for CUDA tensors, the plain version on
    the CPU."""
    if H.device.type == "cuda":
        from singlet_tpu_torch.ops import bell_cuda

        return bell_cuda.bell_mse_bits_cuda(b_li, b_val, words, Wd, H,
                                            gene_block=gene_block)
    return bell_mse_bits_plain(b_li, b_val, words, Wd, H,
                               gene_block=gene_block)

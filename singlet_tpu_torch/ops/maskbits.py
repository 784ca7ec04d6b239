"""Bit-packed, fit-invariant test masks of the ELL engine's masked route.

Port of ``singlet_tpu/ops/maskbits.py`` (``n_word_groups``,
``pack_mask_words``, ``unpack_gene_block``, ``unpack_all``). The speckled
test mask is a pure function of (seed, cell, gene) and the seed is fixed
for a whole fit, so the engine packs it once per fit at one bit per entry
(1 GiB at 524,288 cells x 16,384 genes) and every consumer reads a bit
with one shift and one AND.

Layout, gene BITPLANES tiled to the engine's gene blocks:

  n_gb = genes_pad // gene_block,  n_t = ceil(n_gb / 32)
  words: (cells, n_t * gene_block)
  mask(c, gb * gene_block + w) = (words[c, t * gene_block + w] >> s) & 1
      with t = gb >> 5, s = gb & 31

so bitplane s of word group t holds the whole gene block 32t + s. Only
this natural orientation is stored; the JAX engine's per-block transpose
(``words_t``) exists for the TPU's tiles, and the CUDA kernels index the
natural layout directly.

The words are held as ``torch.int32`` bit patterns of the JAX package's
uint32 words (``words.numpy().view(np.uint32)`` gives them back): this
torch has few uint32 operations, and a shift by s followed by ``& 1``
reads bit s whatever the sign. Validity is baked in when packing: padded
cells and genes are never held out.

The pack runs once per fit in plain PyTorch. Kernel B12
(``unpack_mask_bits``, the TPU kernel ``singlet_tpu/ops/maskbits.py``
``unpack_mask_bits``) expands the words of one group of cells into a dense
int8 0/1 mask once per group for the ``SINGLET_TPU_MASK8=1`` route of the
ELL engine; its plain version is ``unpack_mask_bits_plain`` and its CUDA
kernel ``ops/maskgram_cuda.py`` ``unpack_mask_bits_cuda``.
"""

from __future__ import annotations

from typing import Optional

import torch

from singlet_tpu_torch.ops.rngmask import mask_block

# calls of the plain version of B12 (the kernel counts its own launches)
PLAIN_CALLS = 0


def n_word_groups(n_gb: int) -> int:
    return -(-n_gb // 32)


def pack_mask_words(seed: torch.Tensor, cell_ids: torch.Tensor, *,
                    genes_pad: int, gene_block: int, inv_density: int,
                    cells_true: int, genes_true: int,
                    cell_block: int = 2048) -> torch.Tensor:
    """Pack the validity-clamped test mask of ``cell_ids`` x all genes into
    bitplane words, (len(cell_ids), n_t * gene_block) int32 bit patterns,
    on the device of ``cell_ids``.

    Works slab by slab of ``cell_block`` cells so that the dense mask
    temporary stays (cell_block, genes_pad); a cell count that is no
    multiple halves the slab until it divides, and one that only divides
    into slabs under 64 cells (past 4096 cells) raises, as in JAX."""
    n_gb = genes_pad // gene_block
    n_t = n_word_groups(n_gb)
    cells = cell_ids.shape[0]
    while cells % cell_block:
        cell_block = max(cell_block // 2, 1)
    if cell_block < 64 and cells > 4096:
        raise ValueError(
            f"pack_mask_words: {cells} cells do not divide into "
            f">=64-cell slabs (largest dividing slab {cell_block}); pad "
            f"cell_ids to a multiple of a reasonable block first")
    dev = cell_ids.device
    gene_ids = torch.arange(genes_pad, device=dev)
    gene_ok = gene_ids < genes_true
    shifts = torch.arange(32, dtype=torch.int64, device=dev)
    words = torch.empty((cells, n_t * gene_block), dtype=torch.int32,
                        device=dev)
    for c0 in range(0, cells, cell_block):
        ids = cell_ids[c0:c0 + cell_block]
        m = mask_block(seed, ids, gene_ids, inv_density)
        m = m & (ids < cells_true)[:, None] & gene_ok[None, :]
        m = m.reshape(cell_block, n_gb, gene_block).to(torch.int64)
        if n_t * 32 != n_gb:
            m = torch.nn.functional.pad(m, (0, 0, 0, n_t * 32 - n_gb))
        m = m.reshape(cell_block, n_t, 32, gene_block)
        w = torch.sum(m << shifts[None, None, :, None], dim=2)
        # the uint32 word as its int32 bit pattern (the cast wraps)
        words[c0:c0 + cell_block] = w.reshape(
            cell_block, n_t * gene_block).to(torch.int32)
    return words


def unpack_gene_block(words: torch.Tensor, gb: int,
                      gene_block: int) -> torch.Tensor:
    """Dense bool mask (cells, gene_block) of gene block ``gb`` from packed
    words: one slice, one shift, one AND."""
    t, s = gb // 32, gb % 32
    w = words[:, t * gene_block:(t + 1) * gene_block]
    return ((w >> s) & 1).to(torch.bool)


def unpack_all(words: torch.Tensor, genes_pad: int,
               gene_block: int) -> torch.Tensor:
    """Full dense bool mask (cells, genes_pad)."""
    n_gb = genes_pad // gene_block
    return torch.cat([unpack_gene_block(words, gb, gene_block)
                      for gb in range(n_gb)], dim=1)


def unpack_sub_block(cells: int) -> int:
    """Cells per grid step of the JAX B12: ``min(1024, cells)`` halved until
    it divides ``cells``. JAX then clamps it to at least 8, which leaves the
    trailing cells unwritten where the halving ends below 8 (a cell count
    such as 2050); the port raises there instead."""
    bc = min(1024, cells)
    while bc > 0 and cells % bc:
        bc //= 2
    if cells and bc < 8:
        raise ValueError(
            f"B12 (unpack_mask_bits): {cells} cells do not split into "
            "steps of >= 8 cells; the JAX kernel would leave cells out here")
    return bc


def _check_unpack(words: torch.Tensor, gene_block: int, genes_pad: int):
    if gene_block <= 0 or genes_pad % gene_block:
        raise ValueError(f"genes_pad {genes_pad} is not a multiple of "
                         f"gene_block {gene_block}")
    wcols = n_word_groups(genes_pad // gene_block) * gene_block
    if words.dim() != 2 or words.shape[1] != wcols:
        raise ValueError(f"words must be (cells, {wcols}), got "
                         f"{tuple(words.shape)}")
    unpack_sub_block(words.shape[0])


def unpack_out(out: Optional[torch.Tensor], words: torch.Tensor,
               genes_pad: int) -> torch.Tensor:
    """B12's output: ``out`` (checked) or a new (cells, genes_pad) int8
    tensor on the words' device."""
    shape = (words.shape[0], genes_pad)
    if out is None:
        return torch.empty(shape, dtype=torch.int8, device=words.device)
    if (out.dtype != torch.int8 or tuple(out.shape) != shape
            or out.device != words.device or not out.is_contiguous()):
        raise ValueError(f"out must be a contiguous int8 {shape} tensor on "
                         f"{words.device}, got {out.dtype} "
                         f"{tuple(out.shape)} on {out.device}")
    return out


def unpack_mask_bits_plain(words: torch.Tensor, *, gene_block: int,
                           genes_pad: int,
                           out: Optional[torch.Tensor] = None
                           ) -> torch.Tensor:
    """The plain version of kernel B12: the dense int8 0/1 test mask
    (cells, genes_pad) of packed words (cells, n_t * gene_block), written
    into ``out`` when given; gene block g is bit g % 32 of word group
    g // 32."""
    global PLAIN_CALLS
    PLAIN_CALLS += 1
    _check_unpack(words, gene_block, genes_pad)
    out = unpack_out(out, words, genes_pad)
    return out.copy_(unpack_all(words, genes_pad, gene_block))


def unpack_mask_bits(words: torch.Tensor, *, gene_block: int,
                     genes_pad: int,
                     out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Dispatcher of B12: the kernel for CUDA tensors, the plain version on
    the CPU."""
    if words.device.type == "cuda":
        from singlet_tpu_torch.ops import maskgram_cuda

        return maskgram_cuda.unpack_mask_bits_cuda(
            words, gene_block=gene_block, genes_pad=genes_pad, out=out)
    return unpack_mask_bits_plain(words, gene_block=gene_block,
                                  genes_pad=genes_pad, out=out)

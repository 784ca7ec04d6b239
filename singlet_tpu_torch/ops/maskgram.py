"""The masked packed-Gram products of the ELL engine's masked routes.

Port of ``singlet_tpu/ops/pallas_maskgram.py``: ``maskgram_mode``,
``quantize_pairs``, kernels B10 (``mask_packed_w_t``) and B11
(``mask_packed_h_t``) of the hash route, with the test mask hashed from
(seed, cell, gene), B8 (``mask_packed_w_t_bits``) and B9
(``mask_packed_h_t_bits``) of the bits route, with the mask read from
bitplane words (``ops/maskbits.py``), and B13 (``mask_packed_w_t_m8``) and
B14 (``mask_packed_h_t_m8``) of the bits route under
``SINGLET_TPU_MASK8=1``, with the mask read from a prebuilt dense int8 0/1
array (``maskbits.unpack_mask_bits``, B12):

  * B8/B10/B13, h-side:  packed_t[p, c] = sum_g mask(c, g) * P[g, p]  (np, block)
  * B9/B11/B14, w-side:  acc[p, g]     += sum_c mask(c, g) * P[c, p]  (np, genes)

All six emit the product transposed, the orientation kernel B2's packed
entry (and, on the CPU, the unpack ``linalg.unpack_sym_from_t``) reads. B10 and B11 round the operand
to bf16 (the mask is an exact bf16 0/1) and sum in float32: the plain B10
sums one partial per gene block in gene-block order, the plain B11 adds one
partial per cell sub-block (``_sub_block``, at most 1024 cells) into
``acc`` in sub-block order, as the JAX kernels do; the CUDA kernels sum
all of a call's genes or cells in one float32 accumulator, so they differ
from the plain versions in the order of the sums alone. ``pack_mask_k`` is
the plain version of their hash pass, which packs the mask along the
product's K axis. Their mask is ``rngmask.mask_block`` of the
GLOBAL cell ids (which need not start at 0) with the validity clamps:
cells at or past ``cells_true`` and genes at or past ``genes_true`` are
never held out. The bits route's operand P is either int8, quantized per
pair by ``quantize_pairs`` (int32 sums, exact, then one dequantizing
multiply per pair), or bf16 (f32 sums); the engine builds it from H or W
with ``quantized_pairs``, whose plain version is that chain (on the card
one kernel, ``csrc/quantized_pairs.cu``). B9's ``scale_block`` batches
several independently quantized cell blocks into one call: the scales are
then (np, block // scale_block), one column per block, and the int32
partial of each cell sub-block is dequantized with its own block's column
and added into ``acc`` in sub-block order, exactly as the JAX kernel does;
so one batched call gives the bits of the same calls made block by block.
B13 and B14 compute what B8 and B9 compute, from the mask's bytes: on int8
the sums are the same exact integers, so they give B8's and B9's bits on
the same mask; on bf16 B13 sums one float32 partial per gene block in
gene-block order and B14 one per cell sub-block, as the JAX kernels do.
The CUDA B8 and B13 run B10's GEMM after a pass that packs their block's
mask along the genes, as B10's hash pass does (``pack_words_g``,
``pack_mask8_g``), and B9 and B14 run B11's after a pass that packs it
along the cells (``pack_words_k``, ``pack_mask8_k``): those are the plain
versions of the passes. On int8 that GEMM reads P K-major, so the engine
builds its operands in a ``kmajor_buffer`` (bf16: a ``pair_buffer``); the
plain versions take P in any layout and give the same result.

Left out, because they lay the operand out for the TPU's VMEM and change
nothing that is computed: ``prechunk_pairs``, ``_mpw_geometry`` and the
VMEM budgets, and the pair axis padded to a lane multiple (``pad_pairs``);
here the pair axis has its true length (the hash route's bf16 operands are
views of buffers padded to ``PAIR_PAD``, for TMA).
``SINGLET_TPU_MPH_NOALIAS`` and ``SINGLET_TPU_I8_DIRECT`` choose TPU
memory layouts and are not read; so does the JAX engine's transposed copy
of the prebuilt mask (``m8.T``): B13 reads the mask's rows as they are.

The plain versions below are the CPU path and the reference of the CUDA
kernels (``ops/maskgram_cuda.py``); the dispatchers send CUDA tensors to
the kernels and nothing else.
"""

from __future__ import annotations

import os
from typing import Optional

import torch

from singlet_tpu_torch.ops.linalg import packed_outer_products, triu_pairs
from singlet_tpu_torch.ops.maskbits import unpack_all
from singlet_tpu_torch.ops.rngmask import mask_block

# calls of the plain versions of B8-B11, B13, B14 and the pair operands'
# builder (the kernels count their own launches)
PLAIN_CALLS = 0

_MODES = ("int8", "bf16", "hash", "xla")
# B9's cell sub-block: the grain of its int32 partials (JAX _CELL_SUBBLOCK)
_CELL_SUBBLOCK = 1024


def maskgram_mode() -> str:
    """The masked-product route, from ``SINGLET_TPU_MASKGRAM`` (read when a
    fit is built): int8 (the default), bf16, hash or xla. Unknown values
    mean int8, as in JAX."""
    mode = os.environ.get("SINGLET_TPU_MASKGRAM", "int8").lower()
    return mode if mode in _MODES else "int8"


def quantize_pairs(P: torch.Tensor, axis: int = 0):
    """Symmetric per-pair int8 quantization of a packed-outer-product
    operand, bit for bit the JAX package's: ``axis`` is the reduction
    (gene or cell) axis, the other the pair axis whose max |.| / 127 sets
    the scale (floored at 1e-30, so a zero column stays exact); values
    round half to even and clip to +-127. Returns (q int8, scales f32)."""
    s = P.abs().amax(dim=axis) / 127.0
    s = torch.clamp(s, min=1e-30)
    sb = s[None, :] if axis == 0 else s[:, None]
    q = torch.clamp(torch.round(P / sb), -127, 127).to(torch.int8)
    return q, s.to(torch.float32)


def quantized_pairs_plain(X: torch.Tensor, out: torch.Tensor,
                          scales: torch.Tensor):
    """The plain version of ``csrc/quantized_pairs.cu``: the bits route's
    operand of the rows X (n, k), ``packed_outer_products(X, triu_pairs(k))``
    quantized by ``quantize_pairs`` (``out`` int8) or rounded to bf16 with
    unit scales (``out`` bf16), copied into ``out`` (n, npairs) and
    ``scales`` (npairs,), views of any layout (the engine's: rows of a
    ``kmajor_buffer`` or a ``pair_buffer``, a column of the scales of a
    group). Returns (out, scales)."""
    global PLAIN_CALLS
    PLAIN_CALLS += 1
    P = packed_outer_products(X, triu_pairs(X.shape[1]))
    if out.dtype == torch.int8:
        q, s = quantize_pairs(P, axis=0)
    elif out.dtype == torch.bfloat16:
        q, s = P.to(torch.bfloat16), torch.ones(P.shape[1],
                                                dtype=torch.float32,
                                                device=P.device)
    else:
        raise TypeError(f"the pair operand must be int8 or bfloat16, got "
                        f"{out.dtype}")
    out.copy_(q)
    scales.copy_(s)
    return out, scales


def quantized_pairs(X: torch.Tensor, out: torch.Tensor,
                    scales: torch.Tensor):
    """Dispatcher of the bits route's pair operand (``out`` and ``scales``
    written in place and returned): the kernel for CUDA tensors, the plain
    version on the CPU."""
    if X.device.type == "cuda":
        from singlet_tpu_torch.ops import maskgram_cuda

        return maskgram_cuda.quantized_pairs_cuda(X, out, scales)
    return quantized_pairs_plain(X, out, scales)


def _sub_block(block: int) -> int:
    bc = min(_CELL_SUBBLOCK, block)
    while block % bc:
        bc //= 2
    return bc


def b9_sub_block(block: int, scale_block: int) -> int:
    """Cells per partial of B9 (B11: ``scale_block`` = ``block``): JAX's
    ``min(_sub_block(block), _sub_block(scale_block))``. JAX then clamps
    it to at least 8, which leaves cells out where the halving ends below 8
    (a block that is no multiple of 8); the port raises there instead."""
    if scale_block <= 0 or block % scale_block:
        raise ValueError(f"scale_block {scale_block} does not divide the "
                         f"{block} cells")
    bc = min(_sub_block(block), _sub_block(scale_block))
    if bc < 8:
        raise ValueError(
            f"B9/B11/B14 (mask_packed_h_t*): {block} cells (scale_block "
            f"{scale_block}) do not split into sub-blocks of >= 8 cells; "
            "the JAX kernel would leave cells out here")
    return bc


def m8_sub_block(block: int) -> int:
    """Cells per grid step of the JAX B13: ``block`` halved while it is over
    1024 or does not divide ``block``. JAX then clamps it to at least 8,
    which leaves cells out where the halving ends below 8 (a block such as
    2050); the port raises there instead."""
    bc = block
    while bc > 1024 or (bc > 0 and block % bc):
        bc //= 2
    if block and bc < 8:
        raise ValueError(
            f"B13 (mask_packed_w_t_m8): {block} cells do not split into "
            "steps of >= 8 cells; the JAX kernel would leave cells out here")
    return bc


def hash_mask(seed, cell_ids: torch.Tensor, genes_pad: int, *,
              inv_density: int, cells_true: int,
              genes_true: int) -> torch.Tensor:
    """The validity-clamped test mask of ``cell_ids`` (global ids) x all
    ``genes_pad`` genes, bool (cells, genes_pad), on the ids' device: the
    mask B10 and B11 hash."""
    gene_ids = torch.arange(genes_pad, device=cell_ids.device)
    m = mask_block(seed, cell_ids, gene_ids, inv_density)
    return m & (cell_ids < cells_true)[:, None] \
        & (gene_ids < genes_true)[None, :]


# the CUDA B10/B11 read P through TMA, whose rows must start 16 bytes
# apart: the engine lays its bf16 operands out with the pair axis padded
# to this multiple and hands over the [:, :npairs] view
PAIR_PAD = 64


def pair_buffer(rows: int, npairs: int, device) -> torch.Tensor:
    """A (rows, npairs) bf16 view of an uninitialised (rows, npairs rounded
    up to PAIR_PAD) buffer: the layout in which B10 and B11 take P without
    a copy. Only the view's columns are ever read."""
    width = -(-npairs // PAIR_PAD) * PAIR_PAD
    return torch.empty((rows, width), dtype=torch.bfloat16,
                       device=device)[:, :npairs]


# the CUDA B9/B14 on int8 read P K-major through TMA: the transpose of a
# (npairs, pitch) buffer whose rows start 16 bytes apart
KMAJOR_PAD = 16


def kmajor_buffer(cells: int, npairs: int, device) -> torch.Tensor:
    """A (cells, npairs) int8 view that is the transpose of an
    uninitialised (npairs, cells rounded up to KMAJOR_PAD) buffer: the
    layout in which int8 B9 and B14 take P without a copy (the engine
    writes each block's quantized products into its rows). Only the view's
    entries are ever read."""
    pitch = -(-cells // KMAJOR_PAD) * KMAJOR_PAD
    return torch.empty((npairs, pitch), dtype=torch.int8,
                       device=device)[:, :cells].T


def kmajor_pitch(P: torch.Tensor) -> Optional[int]:
    """The pitch in bytes at which int8 B9/B14 read P (cells, npairs) in
    place: P must be the transpose of rows that start 16 bytes apart (a
    ``kmajor_buffer`` or a column slice of one at a multiple of 16). None
    when P is laid out otherwise, and then the kernel's wrapper copies it
    into a ``kmajor_buffer``."""
    cells = P.shape[0]
    if (P.dtype == torch.int8 and P.dim() == 2 and P.stride(0) == 1
            and P.stride(1) % KMAJOR_PAD == 0 and P.stride(1) >= cells
            and P.data_ptr() % 16 == 0):
        return P.stride(1)
    return None


def k_words(K: int) -> int:
    """Words per row of a mask packed along a product's K axis: ceil(K /
    32) rounded up to 4, a 16-byte row."""
    n = -(-K // 32)
    return -(-n // 4) * 4


def _pack_rows_k(m: torch.Tensor) -> torch.Tensor:
    """A bool (rows, K) mask packed along K into (rows, k_words(K)) int32
    words (the uint32 bit patterns): bit j of word q = column 32 q + j, the
    tails zero."""
    rows, K = m.shape
    kw = k_words(K)
    bits = torch.zeros((rows, kw * 32), dtype=torch.int64, device=m.device)
    bits[:, :K] = m.to(torch.int64)
    shift = torch.arange(32, dtype=torch.int64, device=m.device)
    words = (bits.reshape(rows, kw, 32) << shift).sum(dim=2)
    return torch.where(words >= 2**31, words - 2**32, words).to(torch.int32)


def pack_mask_k(seed, cell_ids: torch.Tensor, genes_pad: int, *,
                gene_rows: bool, inv_density: int, cells_true: int,
                genes_true: int) -> torch.Tensor:
    """The plain version of B10's and B11's hash pass: ``hash_mask`` of
    ``cell_ids`` packed along the product's K axis into int32 words (the
    uint32 bit patterns), the tails zero. B10 (``gene_rows`` False):
    (cells, k_words(genes_pad)), bit s of word j = gene 32 j + s; B11
    (True): (genes_pad, k_words(cells)), bit j of word q = cell 32 q + j."""
    m = hash_mask(seed, cell_ids, genes_pad, inv_density=inv_density,
                  cells_true=cells_true, genes_true=genes_true)
    return _pack_rows_k(m.T if gene_rows else m)


def pack_words_k(words: torch.Tensor, *, gene_block: int,
                 genes_pad: int) -> torch.Tensor:
    """The plain version of B9's pass: the mask of bitplane words (cells,
    n_t * gene_block) packed along the cells, (genes_pad, k_words(cells))
    int32, bit j of word q = cell 32 q + j; for the words of the same seed
    and cells, ``pack_mask_k(..., gene_rows=True)`` word for word."""
    return _pack_rows_k(unpack_all(words, genes_pad, gene_block).T)


def pack_mask8_k(mask8: torch.Tensor) -> torch.Tensor:
    """The plain version of B14's pass: the int8 0/1 mask (cells,
    genes_pad) packed along the cells, as ``pack_words_k`` packs the
    words it was unpacked from."""
    return _pack_rows_k((mask8 != 0).T)


def pack_words_g(words: torch.Tensor, *, gene_block: int,
                 genes_pad: int) -> torch.Tensor:
    """The plain version of B8's pass: the mask of bitplane words (cells,
    n_t * gene_block) packed along the genes, (cells, k_words(genes_pad))
    int32, bit s of word j = gene 32 j + s; for the words of the same seed
    and cells, ``pack_mask_k(..., gene_rows=False)`` word for word."""
    return _pack_rows_k(unpack_all(words, genes_pad, gene_block))


def pack_mask8_g(mask8: torch.Tensor) -> torch.Tensor:
    """The plain version of B13's pass: the int8 0/1 mask (cells,
    genes_pad) packed along the genes, as ``pack_words_g`` packs the
    words it was unpacked from."""
    return _pack_rows_k(mask8 != 0)


def mask_packed_w_t_plain(Pw, seed, cell_ids, *, gene_block: int,
                          inv_density: int, cells_true: int,
                          genes_true: int) -> torch.Tensor:
    """The plain version of kernel B10: (np, block) float32 = (mask @
    bf16(Pw))^T for Pw (genes_pad, np) and the hashed mask of ``cell_ids``
    (block,), one float32 partial per gene block summed in gene-block
    order."""
    global PLAIN_CALLS
    PLAIN_CALLS += 1
    genes_pad = Pw.shape[0]
    P = Pw.to(torch.bfloat16).to(torch.float32)
    m = hash_mask(seed, cell_ids, genes_pad, inv_density=inv_density,
                  cells_true=cells_true, genes_true=genes_true)
    m = m.to(torch.float32)
    out = None
    for g0 in range(0, genes_pad, gene_block):
        part = P[g0:g0 + gene_block].T @ m[:, g0:g0 + gene_block].T
        out = part if out is None else out + part
    return out


def mask_packed_h_t_plain(Ph, seed, cell_ids, acc, *, gene_block: int,
                          inv_density: int, cells_true: int,
                          genes_true: int) -> torch.Tensor:
    """The plain version of kernel B11: ``acc`` (np, genes_pad) float32 +=
    (mask^T @ bf16(Ph))^T for Ph (block, np) and the hashed mask of
    ``cell_ids`` (block,), one float32 partial per cell sub-block
    (``_sub_block``) added in sub-block order; ``acc`` is updated in place
    and returned. ``gene_block`` must divide ``genes_pad``."""
    global PLAIN_CALLS
    PLAIN_CALLS += 1
    block = Ph.shape[0]
    genes_pad = acc.shape[1]
    if genes_pad % gene_block:
        raise ValueError(f"acc has {genes_pad} columns, not a multiple of "
                         f"gene_block {gene_block}")
    bc = b9_sub_block(block, block)
    P = Ph.to(torch.bfloat16).to(torch.float32)
    for c0 in range(0, block, bc):
        m = hash_mask(seed, cell_ids[c0:c0 + bc], genes_pad,
                      inv_density=inv_density, cells_true=cells_true,
                      genes_true=genes_true)
        acc += P[c0:c0 + bc].T @ m.to(torch.float32)
    return acc


def _is_int8(P_op: torch.Tensor) -> bool:
    if P_op.dtype == torch.int8:
        return True
    if P_op.dtype != torch.bfloat16:
        raise TypeError(f"the packed operand must be int8 or bfloat16, got "
                        f"{P_op.dtype}")
    return False


def mask_packed_w_t_bits_plain(P_op, scales, words, *,
                               gene_block: int) -> torch.Tensor:
    """The plain version of kernel B8: (np, block) float32 from P_op
    (genes_pad, np) int8 with ``scales`` (np,) or bf16 (``scales``
    unused), and the block's words (block, n_t * gene_block). The int8
    sums run in float64, where every partial sum is an exact integer."""
    global PLAIN_CALLS
    PLAIN_CALLS += 1
    m_t = unpack_all(words, P_op.shape[0], gene_block).T  # (genes, block)
    if _is_int8(P_op):
        part = P_op.to(torch.float64).T @ m_t.to(torch.float64)
        return part.to(torch.float32) * scales.to(torch.float32)[:, None]
    return P_op.to(torch.float32).T @ m_t.to(torch.float32)


def mask_packed_h_t_bits_plain(P_op, scales, words, acc, *, gene_block: int,
                               scale_block: Optional[int] = None):
    """The plain version of kernel B9: ``acc`` (np, genes_pad) float32 +=
    the dequantized (mask^T @ P)^T, updated in place and returned. P_op
    (cells, np) int8 with ``scales`` (np, cells // scale_block), or bf16;
    words (cells, n_t * gene_block). Per cell sub-block (``b9_sub_block``)
    one exact partial, dequantized with its block's scale column, added
    into ``acc`` in sub-block order."""
    global PLAIN_CALLS
    PLAIN_CALLS += 1
    cells = P_op.shape[0]
    scale_block = cells if scale_block is None else scale_block
    bc = b9_sub_block(cells, scale_block)
    int8 = _is_int8(P_op)
    genes_pad = acc.shape[1]
    for c0 in range(0, cells, bc):
        m = unpack_all(words[c0:c0 + bc], genes_pad, gene_block)
        if int8:
            part = (P_op[c0:c0 + bc].to(torch.float64).T
                    @ m.to(torch.float64)).to(torch.float32)
            d = part * scales[:, c0 // scale_block][:, None]
        else:
            d = P_op[c0:c0 + bc].to(torch.float32).T @ m.to(torch.float32)
        acc += d
    return acc


def _check_m8(mask8: torch.Tensor, rows: int, genes_pad: int,
              gene_block: int):
    if mask8.dtype != torch.int8:
        raise TypeError(f"the mask must be int8, got {mask8.dtype}")
    if tuple(mask8.shape) != (rows, genes_pad):
        raise ValueError(f"the mask must be ({rows}, {genes_pad}), got "
                         f"{tuple(mask8.shape)}")
    if gene_block <= 0 or genes_pad % gene_block:
        raise ValueError(f"{genes_pad} genes are not a multiple of "
                         f"gene_block {gene_block}")


def mask_packed_w_t_m8_plain(P_op, scales, mask8_blk, *,
                             gene_block: int) -> torch.Tensor:
    """The plain version of kernel B13: (np, block) float32 from P_op
    (genes_pad, np) int8 with ``scales`` (np,) or bf16 (``scales``
    unused), and the block's prebuilt int8 0/1 mask (block, genes_pad).
    int8: exact integer sums over all genes (float64 here), times the
    per-pair scale; bf16: one float32 partial per gene block, summed in
    gene-block order."""
    global PLAIN_CALLS
    PLAIN_CALLS += 1
    genes_pad = P_op.shape[0]
    block = mask8_blk.shape[0]
    _check_m8(mask8_blk, block, genes_pad, gene_block)
    m8_sub_block(block)
    if _is_int8(P_op):
        part = P_op.to(torch.float64).T @ mask8_blk.to(torch.float64).T
        return part.to(torch.float32) * scales.to(torch.float32)[:, None]
    P = P_op.to(torch.float32)
    m = mask8_blk.to(torch.float32)
    out = None
    for g0 in range(0, genes_pad, gene_block):
        part = P[g0:g0 + gene_block].T @ m[:, g0:g0 + gene_block].T
        out = part if out is None else out + part
    return out


def mask_packed_h_t_m8_plain(P_op, scales, mask8, acc, *, gene_block: int,
                             scale_block: Optional[int] = None):
    """The plain version of kernel B14: ``acc`` (np, genes_pad) float32 +=
    the dequantized (mask^T @ P)^T, updated in place and returned. P_op
    (cells, np) int8 with ``scales`` (np, cells // scale_block), or bf16;
    mask8 the prebuilt int8 0/1 mask (cells, genes_pad). Per cell sub-block
    (``b9_sub_block``) one exact partial, dequantized with its block's
    scale column, added into ``acc`` in sub-block order: B9's arithmetic."""
    global PLAIN_CALLS
    PLAIN_CALLS += 1
    cells = P_op.shape[0]
    genes_pad = acc.shape[1]
    _check_m8(mask8, cells, genes_pad, gene_block)
    scale_block = cells if scale_block is None else scale_block
    bc = b9_sub_block(cells, scale_block)
    int8 = _is_int8(P_op)
    for c0 in range(0, cells, bc):
        m = mask8[c0:c0 + bc]
        if int8:
            part = (P_op[c0:c0 + bc].to(torch.float64).T
                    @ m.to(torch.float64)).to(torch.float32)
            d = part * scales[:, c0 // scale_block][:, None]
        else:
            d = P_op[c0:c0 + bc].to(torch.float32).T @ m.to(torch.float32)
        acc += d
    return acc


def mask_packed_w_t(Pw, seed, cell_ids, *, gene_block: int,
                    inv_density: int, cells_true: int,
                    genes_true: int) -> torch.Tensor:
    """Dispatcher of B10: the kernel for CUDA tensors, the plain version on
    the CPU."""
    kw = dict(gene_block=gene_block, inv_density=inv_density,
              cells_true=cells_true, genes_true=genes_true)
    if Pw.device.type == "cuda":
        from singlet_tpu_torch.ops import maskgram_cuda

        return maskgram_cuda.mask_packed_w_t_cuda(Pw, seed, cell_ids, **kw)
    return mask_packed_w_t_plain(Pw, seed, cell_ids, **kw)


def mask_packed_h_t(Ph, seed, cell_ids, acc, *, gene_block: int,
                    inv_density: int, cells_true: int,
                    genes_true: int) -> torch.Tensor:
    """Dispatcher of B11 (``acc`` updated in place and returned): the
    kernel for CUDA tensors, the plain version on the CPU."""
    kw = dict(gene_block=gene_block, inv_density=inv_density,
              cells_true=cells_true, genes_true=genes_true)
    if Ph.device.type == "cuda":
        from singlet_tpu_torch.ops import maskgram_cuda

        return maskgram_cuda.mask_packed_h_t_cuda(Ph, seed, cell_ids, acc,
                                                  **kw)
    return mask_packed_h_t_plain(Ph, seed, cell_ids, acc, **kw)


def mask_packed_w_t_bits(P_op, scales, words, *,
                         gene_block: int) -> torch.Tensor:
    """Dispatcher of B8: the kernel for CUDA tensors, the plain version on
    the CPU."""
    if P_op.device.type == "cuda":
        from singlet_tpu_torch.ops import maskgram_cuda

        return maskgram_cuda.mask_packed_w_t_bits_cuda(
            P_op, scales, words, gene_block=gene_block)
    return mask_packed_w_t_bits_plain(P_op, scales, words,
                                      gene_block=gene_block)


def mask_packed_h_t_bits(P_op, scales, words, acc, *, gene_block: int,
                         scale_block: Optional[int] = None):
    """Dispatcher of B9 (``acc`` updated in place and returned): the kernel
    for CUDA tensors, the plain version on the CPU."""
    if P_op.device.type == "cuda":
        from singlet_tpu_torch.ops import maskgram_cuda

        return maskgram_cuda.mask_packed_h_t_bits_cuda(
            P_op, scales, words, acc, gene_block=gene_block,
            scale_block=scale_block)
    return mask_packed_h_t_bits_plain(P_op, scales, words, acc,
                                      gene_block=gene_block,
                                      scale_block=scale_block)


def mask_packed_w_t_m8(P_op, scales, mask8_blk, *,
                       gene_block: int) -> torch.Tensor:
    """Dispatcher of B13: the kernel for CUDA tensors, the plain version on
    the CPU."""
    if P_op.device.type == "cuda":
        from singlet_tpu_torch.ops import maskgram_cuda

        return maskgram_cuda.mask_packed_w_t_m8_cuda(
            P_op, scales, mask8_blk, gene_block=gene_block)
    return mask_packed_w_t_m8_plain(P_op, scales, mask8_blk,
                                    gene_block=gene_block)


def mask_packed_h_t_m8(P_op, scales, mask8, acc, *, gene_block: int,
                       scale_block: Optional[int] = None):
    """Dispatcher of B14 (``acc`` updated in place and returned): the kernel
    for CUDA tensors, the plain version on the CPU."""
    if P_op.device.type == "cuda":
        from singlet_tpu_torch.ops import maskgram_cuda

        return maskgram_cuda.mask_packed_h_t_m8_cuda(
            P_op, scales, mask8, acc, gene_block=gene_block,
            scale_block=scale_block)
    return mask_packed_h_t_m8_plain(P_op, scales, mask8, acc,
                                    gene_block=gene_block,
                                    scale_block=scale_block)

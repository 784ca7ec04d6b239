"""Kernels B8-B14: the masked packed-Gram products and the mask unpack,
hand-written in CUDA.

B8 (``mask_packed_w_t_bits_cuda``) replaces
``singlet_tpu/ops/pallas_maskgram.py`` ``mask_packed_w_t_bits`` and B9
(``mask_packed_h_t_bits_cuda``) replaces ``mask_packed_h_t_bits``, both on
their int8 and bf16 paths, with the test mask read from bitplane words;
B10 (``mask_packed_w_t_cuda``) replaces ``mask_packed_w_t`` and B11
(``mask_packed_h_t_cuda``) replaces ``mask_packed_h_t``, with the mask
hashed from (seed, cell, gene) on the card and bf16 operands. B12
(``unpack_mask_bits_cuda``) replaces ``singlet_tpu/ops/maskbits.py``
``unpack_mask_bits``, B13 (``mask_packed_w_t_m8_cuda``)
``mask_packed_w_t_m8`` and B14 (``mask_packed_h_t_m8_cuda``)
``mask_packed_h_t_m8``: the bits route under ``SINGLET_TPU_MASK8=1``, the
mask unpacked once per group into a dense int8 array that the products
read. ``quantized_pairs_cuda`` builds the bits route's operands of B8/B13
and B9/B14 (``csrc/quantized_pairs.cu``): it replaces no TPU kernel, since
XLA fused that chain in the JAX package.

B8-B11, B13 and B14 are one GEMM with the mask as its A operand, packed
along the product's K axis by a pass that runs first in the same call: a
hash pass (B10/B11; ``pack_mask_k_cuda`` runs it alone), a transpose of
the bitplane words along the genes (B8; ``pack_words_g_cuda``) or the
cells (B9; ``pack_words_k_cuda``), or a pass over the int8 mask along the
genes (B13; ``pack_mask8_g_cuda``) or the cells (B14;
``pack_mask8_k_cuda``). Their source is ``csrc/maskgram_gemm.cu``, that of
B12 ``csrc/maskgram_m8.cu``; their header notes give the designs and what
bounds them on the card.
``_build.py`` compiles each source with nvcc at first use and this module
binds them with ctypes.

On a CUDA tensor each wrapper launches its kernel or raises; on a CPU
tensor it runs the plain version (``ops/maskgram.py``), because there is no
card to launch on. Importing this module needs neither nvcc nor a card.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple, Optional

import torch

from singlet_tpu_torch.ops.bell_cuda import _check_words, _seed_args
from singlet_tpu_torch.ops.maskbits import (_check_unpack,
                                            unpack_mask_bits_plain,
                                            unpack_out)
from singlet_tpu_torch.ops.maskgram import (_check_m8, _is_int8,
                                            b9_sub_block, k_words,
                                            kmajor_buffer, kmajor_pitch,
                                            m8_sub_block,
                                            mask_packed_h_t_bits_plain,
                                            mask_packed_h_t_m8_plain,
                                            mask_packed_h_t_plain,
                                            mask_packed_w_t_bits_plain,
                                            mask_packed_w_t_m8_plain,
                                            mask_packed_w_t_plain,
                                            pack_mask8_g, pack_mask8_k,
                                            pack_mask_k, pack_words_g,
                                            pack_words_k, pair_buffer,
                                            quantized_pairs_plain)
from singlet_tpu_torch.ops.nnls_cuda import _check

# kernel launches (one per wrapper call on CUDA tensors) of B8, B9, B10 and
# B11; read by chip_smoke.py to show that a fit went through the kernels
LAUNCHES_MPW_BITS = 0
LAUNCHES_MPH_BITS = 0
LAUNCHES_MPW_HASH = 0
LAUNCHES_MPH_HASH = 0
# launches of B10's and B11's hash pass alone (``pack_mask_k_cuda``; the
# passes inside B10 and B11 count as theirs)
LAUNCHES_HASH_K = 0
# likewise the passes of B8, B9, B13 and B14 alone (``pack_words_g_cuda``,
# ``pack_words_k_cuda``, ``pack_mask8_g_cuda``, ``pack_mask8_k_cuda``)
LAUNCHES_KPACK = 0
# likewise B12, B13 and B14 (the SINGLET_TPU_MASK8=1 route)
LAUNCHES_UNPACK8 = 0
LAUNCHES_MPW_M8 = 0
LAUNCHES_MPH_M8 = 0
# launches of ``quantized_pairs_cuda`` (the bits route's pair operands: per
# step one for W and one per cell block)
LAUNCHES_PAIRS = 0

_LIB = {}


def _gemm_lib():
    if "gemm" not in _LIB:
        from singlet_tpu_torch import _build

        lib = _build.load("maskgram_gemm")
        vp, ci = ctypes.c_void_p, ctypes.c_int
        u64, ll = ctypes.c_uint64, ctypes.c_longlong
        lib.mask_hash_words.argtypes = [ci, vp, ci, ci, ci, u64, ci, ll, ll,
                                        vp, vp]
        lib.mask_hash_words.restype = ci
        lib.mask_packed_w_t_hash.argtypes = [vp, ll, ci, vp, ci, ci, ci, u64,
                                             ci, ll, ll, vp, vp, vp]
        lib.mask_packed_w_t_hash.restype = ci
        lib.mask_packed_h_t_hash.argtypes = [vp, ll, ci, vp, ci, ci, ci, u64,
                                             ci, ll, ll, vp, vp, vp]
        lib.mask_packed_h_t_hash.restype = ci
        lib.mask_kpack_words.argtypes = [vp, ci, ci, ci, ci, ci, vp, vp]
        lib.mask_kpack_words.restype = ci
        lib.mask_kpack_m8.argtypes = [vp, ci, ci, ci, vp, vp]
        lib.mask_kpack_m8.restype = ci
        lib.mask_packed_h_t_bits.argtypes = [ci, vp, ll, ci, vp, ci, vp, ci,
                                             ci, ci, ci, ci, ci, ci, vp, ci,
                                             vp, vp]
        lib.mask_packed_h_t_bits.restype = ci
        lib.mask_packed_h_t_m8.argtypes = [ci, vp, ll, ci, vp, ci, vp, ci,
                                           ci, ci, ci, vp, ci, vp, vp]
        lib.mask_packed_h_t_m8.restype = ci
        lib.mask_gpack_words.argtypes = [vp, ci, ci, ci, ci, ci, vp, vp]
        lib.mask_gpack_words.restype = ci
        lib.mask_gpack_m8.argtypes = [vp, ci, ci, ci, vp, vp]
        lib.mask_gpack_m8.restype = ci
        lib.mask_packed_w_t_bits.argtypes = [ci, vp, ll, ci, vp, vp, ci, ci,
                                             ci, ci, vp, ci, vp, vp]
        lib.mask_packed_w_t_bits.restype = ci
        lib.mask_packed_w_t_m8.argtypes = [ci, vp, ll, ci, vp, vp, ci, ci,
                                           vp, ci, vp, vp]
        lib.mask_packed_w_t_m8.restype = ci
        lib.maskgram_gemm_error_string.argtypes = [ci]
        lib.maskgram_gemm_error_string.restype = ctypes.c_char_p
        _LIB["gemm"] = lib
    return _LIB["gemm"]


def _m8_lib():
    if "m8" not in _LIB:
        from singlet_tpu_torch import _build

        lib = _build.load("maskgram_m8")
        vp, ci = ctypes.c_void_p, ctypes.c_int
        lib.unpack_mask_bits.argtypes = [vp, ci, ci, ci, ci, vp, vp]
        lib.unpack_mask_bits.restype = ci
        lib.maskgram_m8_error_string.argtypes = [ci]
        lib.maskgram_m8_error_string.restype = ctypes.c_char_p
        _LIB["m8"] = lib
    return _LIB["m8"]


def _pairs_lib():
    if "pairs" not in _LIB:
        from singlet_tpu_torch import _build

        lib = _build.load("quantized_pairs")
        vp, ci, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        lib.quantized_pairs.argtypes = [ci, vp, ll, ci, ci, vp, ll, vp, ll,
                                        ci, ci, vp]
        lib.quantized_pairs.restype = ci
        lib.quantized_pairs_error_string.argtypes = [ci]
        lib.quantized_pairs_error_string.restype = ctypes.c_char_p
        _LIB["pairs"] = lib
    return _LIB["pairs"]


def _raise_on(err, symbol, error_string=None):
    if err != 0:
        error_string = error_string or _gemm_lib().maskgram_gemm_error_string
        msg = error_string(err).decode()
        raise RuntimeError(f"{symbol} launch failed: {msg} ({err})")


def _stream(device):
    return torch.cuda.current_stream(device).cuda_stream


# ``csrc/quantized_pairs.cu``'s tile of pairs (rows i x columns j of the
# triangle), the rows of X a block stages at once (the plan gives each
# block of a cluster one such chunk where there are rows enough), and its
# largest cluster
PAIRS_TILE = 16
PAIRS_CHUNK = 256
PAIRS_MAX_CLUSTER = 8


class PairsPlan(NamedTuple):
    """``quantized_pairs_cuda``'s split of one call (see ``pairs_plan``)."""
    nt: int        # tiles a side of the pair triangle, ceil(k / 16)
    tiles: int     # nt (nt + 1) / 2 tiles (ti <= tj), a cluster each
    cs: int        # blocks of a cluster: the slices of a tile's rows
    slice: int     # rows a slice, a multiple of 128


def pairs_plan(n: int, k: int) -> PairsPlan:
    """The launch of ``quantized_pairs_cuda`` on n rows and k columns: a
    cluster per 16 x 16 tile of pairs, its blocks (one per 256 rows, at
    most 8) on slices of the rows rounded up to 128, so that every row
    lies in one slice and a 4-byte store starts on a multiple of 4."""
    nt = -(-int(k) // PAIRS_TILE)
    cs = max(1, min(PAIRS_MAX_CLUSTER, -(-int(n) // PAIRS_CHUNK)))
    per = -(-int(n) // cs)
    return PairsPlan(nt, nt * (nt + 1) // 2, cs, -(-per // 128) * 128)


def quantized_pairs_cuda(X, out, scales):
    """The bits route's pair operand of the rows X (n, k) float32, n >= 1:
    ``packed_outer_products(X, triu_pairs(k))`` quantized per pair by
    ``quantize_pairs`` into int8 ``out`` (n, npairs), the transpose of rows
    of pairs (``out.stride(0) == 1``: rows of a ``kmajor_buffer``), or
    rounded into bf16 ``out`` with unit scales (``out.stride(1) == 1``:
    rows of a ``pair_buffer``); ``scales`` (npairs,) float32 at any stride
    (a column of a group's scales). One launch of ``csrc/quantized_pairs.cu``,
    which writes both in place (returned) with the bits of PyTorch's own
    chain on the card, and reads the pair order from the indices, so no
    table crosses from the host. On CPU tensors, the plain version."""
    if X.device.type != "cuda":
        return quantized_pairs_plain(X, out, scales)
    global LAUNCHES_PAIRS
    dev = X.device
    if X.dim() != 2 or X.dtype != torch.float32 or X.stride(1) != 1:
        raise ValueError(f"X must be 2-D float32 with unit column stride, "
                         f"got {X.dtype} {tuple(X.shape)} strides "
                         f"{X.stride()}")
    n, k = X.shape
    if n == 0 or k == 0:
        raise ValueError(f"X has shape {tuple(X.shape)}: the per-pair max "
                         "needs rows and columns")
    npairs = k * (k + 1) // 2
    if out.device != dev or tuple(out.shape) != (n, npairs):
        raise ValueError(f"out must be ({n}, {npairs}) on {dev}, got "
                         f"{tuple(out.shape)} on {out.device}")
    if out.dtype == torch.int8 and out.stride(0) == 1:
        int8, ld = 1, out.stride(1)
    elif out.dtype == torch.bfloat16 and out.stride(1) == 1:
        int8, ld = 0, out.stride(0)
    else:
        raise ValueError(
            f"out must be int8 with its cells contiguous (a kmajor_buffer) "
            f"or bf16 with its pairs contiguous (a pair_buffer), got "
            f"{out.dtype} with strides {out.stride()}")
    if (scales.device != dev or scales.dtype != torch.float32
            or tuple(scales.shape) != (npairs,)):
        raise ValueError(f"scales must be ({npairs},) float32 on {dev}, got "
                         f"{scales.dtype} {tuple(scales.shape)} on "
                         f"{scales.device}")
    plan = pairs_plan(n, k)
    lib = _pairs_lib()
    with torch.cuda.device(dev):
        err = lib.quantized_pairs(int8, X.data_ptr(), X.stride(0), n, k,
                                  out.data_ptr(), ld, scales.data_ptr(),
                                  scales.stride(0), plan.cs, plan.slice,
                                  _stream(dev))
    _raise_on(err, "quantized_pairs", lib.quantized_pairs_error_string)
    LAUNCHES_PAIRS += 1
    return out, scales


def mask_packed_w_t_bits_cuda(P_op, scales, words, *,
                              gene_block: int) -> torch.Tensor:
    """Kernel B8: (np, block) float32 = (mask @ P)^T, the mask of the block's
    cells read from ``words`` (block, n_t * gene_block) int32; P_op
    (genes_pad, np) int8 with ``scales`` (np,) float32, or bf16. One launch
    of B8's pass, which packs the words along the genes, and of the shared
    GEMM. int8 P is read in place when it is the transpose of rows 16 bytes
    apart (``kmajor_buffer``), bf16 P when its rows start 16 bytes apart
    (``pair_buffer``); anything else is copied into such a buffer first. On
    CPU tensors, the plain version."""
    if P_op.device.type != "cuda":
        return mask_packed_w_t_bits_plain(P_op, scales, words,
                                          gene_block=gene_block)
    global LAUNCHES_MPW_BITS
    dev = P_op.device
    genes_pad, np_ = P_op.shape
    if genes_pad % gene_block:
        raise ValueError(f"P has {genes_pad} rows, not a multiple of "
                         f"gene_block {gene_block}")
    n_gb = genes_pad // gene_block
    block = words.shape[0]
    _check_words(words, block, n_gb, gene_block, dev)
    int8, P, p_ld, s_ptr = _gemm_operand(P_op, scales, (np_,))
    out = torch.empty((np_, block), dtype=torch.float32, device=dev)
    if block == 0 or np_ == 0:
        return out
    kwords = torch.empty((block, k_words(genes_pad)), dtype=torch.int32,
                         device=dev)
    lib = _gemm_lib()
    with torch.cuda.device(dev):
        err = lib.mask_packed_w_t_bits(
            int8, P.data_ptr(), p_ld, np_, s_ptr, words.data_ptr(), block,
            words.shape[1], gene_block, n_gb, kwords.data_ptr(),
            kwords.shape[1], out.data_ptr(), _stream(dev))
    _raise_on(err, "mask_packed_w_t_bits", lib.maskgram_gemm_error_string)
    LAUNCHES_MPW_BITS += 1
    return out


def _gemm_operand(P_op, scales, scales_shape):
    """P and its scales as the shared GEMM reads them: (int8 flag, P, P's
    pitch, the scales' pointer). int8 P goes K-major with its pitch in
    bytes (``_kmajor_operand``), beside ``scales`` of ``scales_shape``;
    bf16 P with its row stride (``_tma_operand``), without scales."""
    if _is_int8(P_op):
        _check("scales", scales, scales_shape, torch.float32, P_op.device)
        P, p_ld = _kmajor_operand(P_op)
        return 1, P, p_ld, scales.data_ptr()
    P = _tma_operand(P_op)
    return 0, P, P.stride(0), None


def mask_packed_h_t_bits_cuda(P_op, scales, words, acc, *, gene_block: int,
                              scale_block: Optional[int] = None):
    """Kernel B9: ``acc`` (np, genes_pad) float32 += the dequantized
    (mask^T @ P)^T, in place (returned). P_op (cells, np) int8 with
    ``scales`` (np, cells // scale_block), or bf16; words (cells, n_t *
    gene_block) int32. One launch of B9's pass, which packs the words
    along the cells, and of the shared GEMM. int8 P is read in place when
    it is the transpose of rows 16 bytes apart (``kmajor_buffer``), bf16 P
    when its rows start 16 bytes apart (``pair_buffer``); anything else is
    copied into such a buffer first. On CPU tensors, the plain version."""
    if P_op.device.type != "cuda":
        return mask_packed_h_t_bits_plain(P_op, scales, words, acc,
                                          gene_block=gene_block,
                                          scale_block=scale_block)
    global LAUNCHES_MPH_BITS
    dev = P_op.device
    cells, np_ = P_op.shape
    genes_pad = acc.shape[1]
    if genes_pad % gene_block:
        raise ValueError(f"acc has {genes_pad} columns, not a multiple of "
                         f"gene_block {gene_block}")
    n_gb = genes_pad // gene_block
    _check_words(words, cells, n_gb, gene_block, dev)
    int8, P, p_ld, s_ptr, n_scales, bc, scale_block = _carry_inputs(
        P_op, scales, acc, scale_block)
    if cells == 0 or np_ == 0:
        return acc
    kwords = torch.empty((genes_pad, k_words(cells)), dtype=torch.int32,
                         device=dev)
    lib = _gemm_lib()
    with torch.cuda.device(dev):
        err = lib.mask_packed_h_t_bits(
            int8, P.data_ptr(), p_ld, np_, s_ptr, n_scales, words.data_ptr(),
            cells, words.shape[1], gene_block, n_gb, genes_pad, bc,
            scale_block, kwords.data_ptr(), kwords.shape[1], acc.data_ptr(),
            _stream(dev))
    _raise_on(err, "mask_packed_h_t_bits", lib.maskgram_gemm_error_string)
    LAUNCHES_MPH_BITS += 1
    return acc


def _carry_inputs(P_op, scales, acc, scale_block):
    """The common checks and inputs of B9 and B14: ``_gemm_operand``'s,
    then the quantization groups, the sub-block's cells and
    scale_block."""
    dev = P_op.device
    cells, np_ = P_op.shape
    scale_block = cells if scale_block is None else int(scale_block)
    bc = b9_sub_block(cells, scale_block)
    if scale_block % bc:
        raise ValueError(
            f"B9/B14: {cells} cells in quantization groups of {scale_block} "
            f"sum sub-blocks of {bc} cells, which straddle the groups; the "
            "kernel takes sub-blocks that divide the group")
    _check("acc", acc, (np_, acc.shape[1]), torch.float32, dev)
    n_scales = cells // scale_block
    return (*_gemm_operand(P_op, scales, (np_, n_scales)), n_scales, bc,
            scale_block)


def _kmajor_operand(P: torch.Tensor):
    """int8 P (K, np) as the K-major B operand of the int8 GEMM (K the
    cells of B9/B14, the genes of B8/B13): (a tensor whose data pointer
    starts the (np, pitch) rows, the pitch in bytes). The transpose of rows
    16 bytes apart (``kmajor_pitch``) is used as it is, as the engine hands
    its operands over; anything else is copied into a ``kmajor_buffer``."""
    pitch = kmajor_pitch(P)
    if pitch is not None:
        return P, pitch
    buf = kmajor_buffer(P.shape[0], P.shape[1], P.device)
    buf.copy_(P)
    return buf, buf.stride(1)


def pack_words_k_cuda(words, *, gene_block: int,
                      genes_pad: int) -> torch.Tensor:
    """B9's pass alone: bitplane words (cells, n_t * gene_block) packed
    along the cells, the (genes_pad, k_words(cells)) int32 words
    ``pack_words_k`` builds. On CPU tensors, the plain version."""
    if words.device.type != "cuda":
        return pack_words_k(words, gene_block=gene_block,
                            genes_pad=genes_pad)
    global LAUNCHES_KPACK
    if gene_block <= 0 or genes_pad % gene_block:
        raise ValueError(f"{genes_pad} genes are not a multiple of "
                         f"gene_block {gene_block}")
    cells = words.shape[0]
    n_gb = genes_pad // gene_block
    _check_words(words, cells, n_gb, gene_block, words.device)
    out = torch.empty((genes_pad, k_words(cells)), dtype=torch.int32,
                      device=words.device)
    if cells == 0 or genes_pad == 0:
        return out.zero_()
    lib = _gemm_lib()
    with torch.cuda.device(words.device):
        err = lib.mask_kpack_words(words.data_ptr(), cells, words.shape[1],
                                   gene_block, n_gb, out.shape[1],
                                   out.data_ptr(), _stream(words.device))
    _raise_on(err, "mask_kpack_words", lib.maskgram_gemm_error_string)
    LAUNCHES_KPACK += 1
    return out


def pack_mask8_k_cuda(mask8) -> torch.Tensor:
    """B14's pass alone: the int8 0/1 mask (cells, genes_pad) packed along
    the cells, the (genes_pad, k_words(cells)) int32 words ``pack_mask8_k``
    builds. On CPU tensors, the plain version."""
    if mask8.device.type != "cuda":
        return pack_mask8_k(mask8)
    global LAUNCHES_KPACK
    cells, genes_pad = mask8.shape
    _check("mask8", mask8, (cells, genes_pad), torch.int8, mask8.device)
    out = torch.empty((genes_pad, k_words(cells)), dtype=torch.int32,
                      device=mask8.device)
    if cells == 0 or genes_pad == 0:
        return out.zero_()
    lib = _gemm_lib()
    with torch.cuda.device(mask8.device):
        err = lib.mask_kpack_m8(mask8.data_ptr(), cells, genes_pad,
                                out.shape[1], out.data_ptr(),
                                _stream(mask8.device))
    _raise_on(err, "mask_kpack_m8", lib.maskgram_gemm_error_string)
    LAUNCHES_KPACK += 1
    return out


def pack_words_g_cuda(words, *, gene_block: int,
                      genes_pad: int) -> torch.Tensor:
    """B8's pass alone: bitplane words (cells, n_t * gene_block) packed
    along the genes, the (cells, k_words(genes_pad)) int32 words
    ``pack_words_g`` builds. On CPU tensors, the plain version."""
    if words.device.type != "cuda":
        return pack_words_g(words, gene_block=gene_block,
                            genes_pad=genes_pad)
    global LAUNCHES_KPACK
    if gene_block <= 0 or genes_pad % gene_block:
        raise ValueError(f"{genes_pad} genes are not a multiple of "
                         f"gene_block {gene_block}")
    cells = words.shape[0]
    n_gb = genes_pad // gene_block
    _check_words(words, cells, n_gb, gene_block, words.device)
    out = torch.empty((cells, k_words(genes_pad)), dtype=torch.int32,
                      device=words.device)
    if cells == 0 or genes_pad == 0:
        return out.zero_()
    lib = _gemm_lib()
    with torch.cuda.device(words.device):
        err = lib.mask_gpack_words(words.data_ptr(), cells, words.shape[1],
                                   gene_block, n_gb, out.shape[1],
                                   out.data_ptr(), _stream(words.device))
    _raise_on(err, "mask_gpack_words", lib.maskgram_gemm_error_string)
    LAUNCHES_KPACK += 1
    return out


def pack_mask8_g_cuda(mask8) -> torch.Tensor:
    """B13's pass alone: the int8 0/1 mask (cells, genes_pad) packed along
    the genes, the (cells, k_words(genes_pad)) int32 words ``pack_mask8_g``
    builds. On CPU tensors, the plain version."""
    if mask8.device.type != "cuda":
        return pack_mask8_g(mask8)
    global LAUNCHES_KPACK
    cells, genes_pad = mask8.shape
    _check("mask8", mask8, (cells, genes_pad), torch.int8, mask8.device)
    out = torch.empty((cells, k_words(genes_pad)), dtype=torch.int32,
                      device=mask8.device)
    if cells == 0 or genes_pad == 0:
        return out.zero_()
    lib = _gemm_lib()
    with torch.cuda.device(mask8.device):
        err = lib.mask_gpack_m8(mask8.data_ptr(), cells, genes_pad,
                                out.shape[1], out.data_ptr(),
                                _stream(mask8.device))
    _raise_on(err, "mask_gpack_m8", lib.maskgram_gemm_error_string)
    LAUNCHES_KPACK += 1
    return out


def _hash_inputs(P, seed, cell_ids, genes_pad: int, gene_block: int,
                 inv_density: int, cells_true: int, genes_true: int):
    """The common checks and inputs of B10 and B11: P as a bf16 operand
    whose rows TMA can read (``_tma_operand``), the cell ids as int32 on
    P's device and the hash pass's arguments from the 64-bit seed on."""
    dev = P.device
    if genes_pad % gene_block:
        raise ValueError(f"{genes_pad} genes are not a multiple of "
                         f"gene_block {gene_block}")
    if not 1 <= int(inv_density) < 65536:
        raise ValueError(f"inv_density must be in [1, 65536), got "
                         f"{inv_density}")
    if cell_ids.device != dev:
        raise ValueError(f"cell_ids is on {cell_ids.device}, expected {dev}")
    if cell_ids.dim() != 1:
        raise ValueError(f"cell_ids must be 1-D, got {tuple(cell_ids.shape)}")
    ids = cell_ids.to(torch.int32).contiguous()
    _, seed64 = _seed_args(seed, inv_density)
    return (_tma_operand(P), ids,
            (seed64, int(inv_density), int(cells_true), int(genes_true)))


def _tma_operand(P: torch.Tensor) -> torch.Tensor:
    """P as the bf16 B operand of the bf16 GEMM: a view whose rows start 16
    bytes apart (a row stride that is a multiple of 8, the base 16-byte
    aligned) is used as it is, as the engine hands its operands over;
    anything else is copied into a ``pair_buffer``."""
    if (P.dtype == torch.bfloat16 and P.dim() == 2 and P.stride(1) == 1
            and P.stride(0) % 8 == 0 and P.stride(0) >= P.shape[1]
            and P.data_ptr() % 16 == 0):
        return P
    buf = pair_buffer(P.shape[0], P.shape[1], P.device)
    buf.copy_(P)
    return buf


def pack_mask_k_cuda(seed, cell_ids, genes_pad: int, *, gene_rows: bool,
                     inv_density: int, cells_true: int,
                     genes_true: int) -> torch.Tensor:
    """The hash pass of B10 (``gene_rows`` False) and B11 (True) alone: the
    K-packed int32 words ``pack_mask_k`` builds, hashed on the card. On CPU
    tensors, the plain version."""
    kw = dict(gene_rows=gene_rows, inv_density=inv_density,
              cells_true=cells_true, genes_true=genes_true)
    if cell_ids.device.type != "cuda":
        return pack_mask_k(seed, cell_ids, genes_pad, **kw)
    global LAUNCHES_HASH_K
    if not 1 <= int(inv_density) < 65536:
        raise ValueError(f"inv_density must be in [1, 65536), got "
                         f"{inv_density}")
    dev = cell_ids.device
    ids = cell_ids.to(torch.int32).contiguous()
    cells = ids.shape[0]
    rows, K = (genes_pad, cells) if gene_rows else (cells, genes_pad)
    words = torch.empty((rows, k_words(K)), dtype=torch.int32, device=dev)
    if cells == 0 or genes_pad == 0:
        return words.zero_()
    _, seed64 = _seed_args(seed, inv_density)
    lib = _gemm_lib()
    with torch.cuda.device(dev):
        err = lib.mask_hash_words(
            int(gene_rows), ids.data_ptr(), cells, genes_pad, words.shape[1],
            seed64, int(inv_density), int(cells_true), int(genes_true),
            words.data_ptr(), _stream(dev))
    _raise_on(err, "mask_hash_words", lib.maskgram_gemm_error_string)
    LAUNCHES_HASH_K += 1
    return words


def mask_packed_w_t_cuda(Pw, seed, cell_ids, *, gene_block: int,
                         inv_density: int, cells_true: int,
                         genes_true: int) -> torch.Tensor:
    """Kernel B10: (np, block) float32 = (mask @ bf16(Pw))^T for Pw
    (genes_pad, np), float32 or bf16, and the validity-clamped test mask of
    ``cell_ids`` (block,) (global ids) hashed on the card; all genes summed
    in one float32 accumulator. Pw is read in place when it is a bf16 view
    of a ``pair_buffer`` (or any rows 16 bytes apart), else copied into one.
    On CPU tensors, the plain version."""
    kw = dict(gene_block=gene_block, inv_density=inv_density,
              cells_true=cells_true, genes_true=genes_true)
    if Pw.device.type != "cuda":
        return mask_packed_w_t_plain(Pw, seed, cell_ids, **kw)
    global LAUNCHES_MPW_HASH
    dev = Pw.device
    genes_pad, np_ = Pw.shape
    P, ids, hash_args = _hash_inputs(Pw, seed, cell_ids, genes_pad,
                                     gene_block, inv_density, cells_true,
                                     genes_true)
    block = ids.shape[0]
    out = torch.empty((np_, block), dtype=torch.float32, device=dev)
    if block == 0 or np_ == 0:
        return out
    words = torch.empty((block, k_words(genes_pad)), dtype=torch.int32,
                        device=dev)
    lib = _gemm_lib()
    with torch.cuda.device(dev):
        err = lib.mask_packed_w_t_hash(
            P.data_ptr(), P.stride(0), np_, ids.data_ptr(), block, genes_pad,
            words.shape[1], *hash_args, words.data_ptr(), out.data_ptr(),
            _stream(dev))
    _raise_on(err, "mask_packed_w_t_hash", lib.maskgram_gemm_error_string)
    LAUNCHES_MPW_HASH += 1
    return out


def mask_packed_h_t_cuda(Ph, seed, cell_ids, acc, *, gene_block: int,
                         inv_density: int, cells_true: int,
                         genes_true: int) -> torch.Tensor:
    """Kernel B11: ``acc`` (np, genes_pad) float32 += (mask^T @
    bf16(Ph))^T, in place (returned), for Ph (block, np) and the
    validity-clamped test mask of ``cell_ids`` (block,) hashed on the card;
    all the block's cells summed in one float32 accumulator (the JAX
    kernel's 1024-cell sub-block partials are not formed), each carry
    element read and written once. A block that the JAX sub-block clamp
    would cut short raises, as the plain version does. Ph is read in place
    when it is a bf16 view of a ``pair_buffer``, else copied into one. On
    CPU tensors, the plain version."""
    kw = dict(gene_block=gene_block, inv_density=inv_density,
              cells_true=cells_true, genes_true=genes_true)
    if Ph.device.type != "cuda":
        return mask_packed_h_t_plain(Ph, seed, cell_ids, acc, **kw)
    global LAUNCHES_MPH_HASH
    dev = Ph.device
    block, np_ = Ph.shape
    genes_pad = acc.shape[1]
    _check("acc", acc, (np_, genes_pad), torch.float32, dev)
    P, ids, hash_args = _hash_inputs(Ph, seed, cell_ids, genes_pad,
                                     gene_block, inv_density, cells_true,
                                     genes_true)
    if ids.shape[0] != block:
        raise ValueError(f"{ids.shape[0]} cell ids for {block} rows of Ph")
    if block == 0 or np_ == 0:
        return acc
    b9_sub_block(block, block)
    words = torch.empty((genes_pad, k_words(block)), dtype=torch.int32,
                        device=dev)
    lib = _gemm_lib()
    with torch.cuda.device(dev):
        err = lib.mask_packed_h_t_hash(
            P.data_ptr(), P.stride(0), np_, ids.data_ptr(), block, genes_pad,
            words.shape[1], *hash_args, words.data_ptr(), acc.data_ptr(),
            _stream(dev))
    _raise_on(err, "mask_packed_h_t_hash", lib.maskgram_gemm_error_string)
    LAUNCHES_MPH_HASH += 1
    return acc


def unpack_mask_bits_cuda(words, *, gene_block: int, genes_pad: int,
                          out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Kernel B12: the dense int8 0/1 test mask (cells, genes_pad) of packed
    words (cells, n_t * gene_block) int32, written into ``out`` when given.
    On CPU tensors, the plain version."""
    if words.device.type != "cuda":
        return unpack_mask_bits_plain(words, gene_block=gene_block,
                                      genes_pad=genes_pad, out=out)
    global LAUNCHES_UNPACK8
    _check_unpack(words, gene_block, genes_pad)
    cells = words.shape[0]
    n_gb = genes_pad // gene_block
    _check("words", words, (cells, words.shape[1]), torch.int32,
           words.device)
    out = unpack_out(out, words, genes_pad)
    if cells == 0 or genes_pad == 0:
        return out
    lib = _m8_lib()
    with torch.cuda.device(words.device):
        err = lib.unpack_mask_bits(words.data_ptr(), cells, words.shape[1],
                                   gene_block, n_gb, out.data_ptr(),
                                   _stream(words.device))
    _raise_on(err, "unpack_mask_bits", lib.maskgram_m8_error_string)
    LAUNCHES_UNPACK8 += 1
    return out


def mask_packed_w_t_m8_cuda(P_op, scales, mask8_blk, *,
                            gene_block: int) -> torch.Tensor:
    """Kernel B13: (np, block) float32 = (mask @ P)^T, the mask the block's
    rows (block, genes_pad) of a prebuilt int8 0/1 mask; P_op (genes_pad,
    np) int8 with ``scales`` (np,) float32, or bf16. One launch of B13's
    pass, which packs the mask along the genes, and of B8's GEMM: B8's
    arithmetic (so B8's bits on int8 and on bf16), and P read in place as
    B8 reads it. On CPU tensors, the plain version."""
    if P_op.device.type != "cuda":
        return mask_packed_w_t_m8_plain(P_op, scales, mask8_blk,
                                        gene_block=gene_block)
    global LAUNCHES_MPW_M8
    dev = P_op.device
    genes_pad, np_ = P_op.shape
    block = mask8_blk.shape[0]
    _check_m8(mask8_blk, block, genes_pad, gene_block)
    m8_sub_block(block)
    _check("mask8", mask8_blk, (block, genes_pad), torch.int8, dev)
    int8, P, p_ld, s_ptr = _gemm_operand(P_op, scales, (np_,))
    out = torch.empty((np_, block), dtype=torch.float32, device=dev)
    if block == 0 or np_ == 0:
        return out
    kwords = torch.empty((block, k_words(genes_pad)), dtype=torch.int32,
                         device=dev)
    lib = _gemm_lib()
    with torch.cuda.device(dev):
        err = lib.mask_packed_w_t_m8(
            int8, P.data_ptr(), p_ld, np_, s_ptr, mask8_blk.data_ptr(), block,
            genes_pad, kwords.data_ptr(), kwords.shape[1], out.data_ptr(),
            _stream(dev))
    _raise_on(err, "mask_packed_w_t_m8", lib.maskgram_gemm_error_string)
    LAUNCHES_MPW_M8 += 1
    return out


def mask_packed_h_t_m8_cuda(P_op, scales, mask8, acc, *, gene_block: int,
                            scale_block: Optional[int] = None):
    """Kernel B14: ``acc`` (np, genes_pad) float32 += the dequantized
    (mask^T @ P)^T, in place (returned). P_op (cells, np) int8 with
    ``scales`` (np, cells // scale_block), or bf16; mask8 the prebuilt int8
    0/1 mask (cells, genes_pad). One launch of B14's pass, which packs the
    mask along the cells, and of B9's GEMM: B9's arithmetic, and P read in
    place as B9 reads it. On CPU tensors, the plain version."""
    if P_op.device.type != "cuda":
        return mask_packed_h_t_m8_plain(P_op, scales, mask8, acc,
                                        gene_block=gene_block,
                                        scale_block=scale_block)
    global LAUNCHES_MPH_M8
    dev = P_op.device
    cells, np_ = P_op.shape
    genes_pad = acc.shape[1]
    _check_m8(mask8, cells, genes_pad, gene_block)
    _check("mask8", mask8, (cells, genes_pad), torch.int8, dev)
    int8, P, p_ld, s_ptr, n_scales, bc, scale_block = _carry_inputs(
        P_op, scales, acc, scale_block)
    if cells == 0 or np_ == 0:
        return acc
    kwords = torch.empty((genes_pad, k_words(cells)), dtype=torch.int32,
                         device=dev)
    lib = _gemm_lib()
    with torch.cuda.device(dev):
        err = lib.mask_packed_h_t_m8(
            int8, P.data_ptr(), p_ld, np_, s_ptr, n_scales, mask8.data_ptr(),
            cells, genes_pad, bc, scale_block, kwords.data_ptr(),
            kwords.shape[1], acc.data_ptr(), _stream(dev))
    _raise_on(err, "mask_packed_h_t_m8", lib.maskgram_gemm_error_string)
    LAUNCHES_MPH_M8 += 1
    return acc

"""Bytes and operations of the kernels' calls, from their shapes, and the
least time the card could take for them.

Each input byte is counted once and each output byte once, whatever the
kernel reads again; operations are those the inputs need: a sparse
product's multiply-adds at its stored entries, a mask product's at its
held-out entries. So a call's work is the same whatever kernel computes
it. Peaks: NVIDIA's data sheet for the H100 SXM (dense rates, 700 W):
3.35 TB/s of HBM, 67 TFLOP/s in float32 outside the tensor cores, 1,979
TOP/s in int8, 989 TFLOP/s in bf16.
"""

from __future__ import annotations

HBM_BYTES_S = 3.35e12
PEAK_OPS_S = {"f32": 67e12, "int8": 1979e12, "bf16": 989e12}


def bound_s(nbytes: float, ops: float, kind: str) -> float:
    """The larger of the bytes over the memory rate and the operations over
    the peak of their type."""
    return max(nbytes / HBM_BYTES_S, ops / PEAK_OPS_S[kind])


def spmm(planes_rows: int, cells: int, nnz: int, k: int, genes_pad: int,
         word_cols: int = 0):
    """B3/B4 (and B5/B6 with ``word_cols`` words a cell of test bits): the
    int32 gene ids and float32 values of the planes, the test words, the
    dense factor read (genes_pad or cells rows of k floats), the product
    written (the other side), and 2 k operations a stored entry.
    Returns (bytes, ops). B3 reads W (genes_pad, k) and writes (cells, k);
    B4 reads H (cells, k) and writes (genes_pad, k): the same count."""
    nbytes = 8 * planes_rows * cells + 4 * cells * word_cols \
        + 4 * genes_pad * k + 4 * cells * k
    return nbytes, 2 * nnz * k


def mask_gemm_w(genes_pad: int, npairs: int, cells: int, word_cols: int,
                held_out: int, op_bytes: int = 1):
    """B8 (``mask_packed_w_t_bits``): the quantized pair operand (genes_pad,
    npairs) and its scales, the block's test words, the (npairs, cells)
    float32 corrections written; 2 npairs operations a held-out entry."""
    nbytes = op_bytes * genes_pad * npairs + 4 * npairs \
        + 4 * cells * word_cols + 4 * npairs * cells
    return nbytes, 2 * held_out * npairs


def mask_gemm_h(cells: int, npairs: int, groups: int, word_cols: int,
                genes_pad: int, held_out: int, op_bytes: int = 1):
    """B9 (``mask_packed_h_t_bits``): the group's quantized pair operand
    (cells, npairs) and its per-block scales, the group's test words, and
    the (npairs, genes_pad) float32 carry read and written; 2 npairs
    operations a held-out entry."""
    nbytes = op_bytes * cells * npairs + 4 * npairs * groups \
        + 4 * cells * word_cols + 8 * npairs * genes_pad
    return nbytes, 2 * held_out * npairs

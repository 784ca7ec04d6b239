"""The plain reference: one ALS step of the fits the benchmark times, in
float64 PyTorch, and the held-out test MSE.

Frozen copies of the rules the program follows (``singlet_tpu_torch``,
itself a port of zdebruine/singlet), kept here so that a change to the
program cannot move the yardstick; nothing here imports the program:

* ``init_w``: W drawn U(0, 1) by a ``torch.Generator`` seeded with the
  fit's seed on the fit's device, zero on padded rows
  (reference:R/run_nmf.R:56);
* ``mask_block``: the speckled test set, a stateless xorshift hash of
  (seed, cell, gene) held out when it is 0 mod ``inv_density``
  (reference:src/singlet.cpp:30-95), in (hi, lo) 32-bit halves;
* ``sweep_cap``: the adaptive sweep schedule of the CD solves (a fast
  cap until the fit's tol first falls to ``max(10 tol_target, 1e-4)``,
  then ``max_sweeps``);
* ``cd_nnls``: sequential coordinate descent with the reference's exit
  (reference:src/singlet.cpp:229-250): warm start, residual from the raw
  right-hand side, ``delta = max(b_i / a_ii - L1, -x_i)``, exit
  at ``sum |dx| / (x + 1e-15) / k <= 1e-8`` or at the cap;
* ``quantize``: symmetric per-pair quantization of the packed outer
  products (max |.| over the reduction axis / q_max, round half to even),
  as the bits route quantizes its mask products at int8.

A step's half-updates (reference:src/singlet.cpp:639-666, masked
1107-1114): solve every column of A against the other factor, rescale to
unit column sums, then the other side. The masked step removes the held-out
entries from the right-hand sides and each column's Gram
(reference:src/singlet.cpp:436-466). Columns are independent given the
other factor, so the half-updates take a sample of columns.

``Precision`` says how the products are computed: float64 for the
reference, or a lower precision for the control (TF32 rounding of every
product's inputs, a coarser quantization of the mask products).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

M32 = 0xFFFFFFFF
CD_TOL = 1e-8


# ---------------------------------------------------------------- precision

@dataclasses.dataclass(frozen=True)
class Precision:
    """How the reference computes: ``dtype`` of the arithmetic, whether the
    inputs of every product are rounded to TF32 (10 explicit mantissa
    bits), ``q_max`` of the mask-product quantization (127 for int8, 7
    for int4, None for exact products), and the type that the inputs of
    the tol's sums (float32 reductions in the program, not products) are
    rounded to (None: not rounded)."""

    dtype: torch.dtype = torch.float64
    tf32: bool = False
    q_max: Optional[int] = 127
    tol_inputs: Optional[torch.dtype] = None


def tf32_round(x: torch.Tensor) -> torch.Tensor:
    """float32 ``x`` rounded to the nearest TF32 value (ties to even), as
    the tensor cores read float32 inputs under TF32."""
    x = x.to(torch.float32).contiguous()
    i = x.view(torch.int32)
    bias = 0xFFF + ((i >> 13) & 1)
    return ((i + bias) & ~0x1FFF).view(torch.float32)


def mm(a: torch.Tensor, b: torch.Tensor, prec: Precision) -> torch.Tensor:
    """a @ b in ``prec``: float32 products of TF32-rounded inputs, or plain
    products in ``prec.dtype``."""
    if prec.tf32:
        return tf32_round(a) @ tf32_round(b)
    return a.to(prec.dtype) @ b.to(prec.dtype)


# ------------------------------------------------------------ frozen rules

def init_w(k: int, genes_pad: int, genes_true: int, seed: int,
           device) -> torch.Tensor:
    """The fit's initial W (genes_pad, k) float32."""
    gen = torch.Generator(device=device).manual_seed(int(seed))
    w = torch.rand((genes_pad, k), generator=gen, dtype=torch.float32,
                   device=device)
    w[genes_true:] = 0.0
    return w


def _shl(a, s):
    hi, lo = a
    if s < 32:
        return ((hi << s) | (lo >> (32 - s))) & M32, (lo << s) & M32
    return (lo << (s - 32)) & M32, torch.zeros_like(lo)


def _shr(a, s):
    hi, lo = a
    if s < 32:
        return hi >> s, ((lo >> s) | (hi << (32 - s))) & M32
    return torch.zeros_like(hi), hi >> (s - 32)


def _add(a, b):
    lo = a[1] + b[1]
    return (a[0] + b[0] + (lo >> 32)) & M32, lo & M32


def _xs(a, shifts):
    for direction, s in shifts:
        b = _shl(a, s) if direction == "l" else _shr(a, s)
        a = (a[0] ^ b[0], a[1] ^ b[1])
    return a


_I_MIX = (("l", 19), ("r", 7), ("l", 36))
_X_MIX = (("l", 38), ("r", 13), ("l", 23))
_J_MIX = (("r", 7), ("l", 23), ("r", 8))
_XJ_MIX = (("r", 7), ("l", 53), ("r", 4))


def mask_block(mask_seed: int, cell_ids: torch.Tensor,
               gene_ids: torch.Tensor, inv_density: int) -> torch.Tensor:
    """bool (cells, genes): True where (gene, cell) is held out."""
    s = int(mask_seed) & ((1 << 64) - 1)
    seed = (s >> 32, s & M32)
    ci = cell_ids.to(torch.int64) & M32
    xi = _xs(_add(seed, _xs((torch.zeros_like(ci), ci), _I_MIX)), _X_MIX)
    gj = gene_ids.to(torch.int64) & M32
    jm = _xs((torch.zeros_like(gj), gj), _J_MIX)
    x = _xs(_add((xi[0][:, None], xi[1][:, None]),
                 (jm[0][None, :], jm[1][None, :])), _XJ_MIX)
    d = int(inv_density)
    return ((x[0] % d) * ((1 << 32) % d) + x[1] % d) % d == 0


def test_mask(mask_seed: int, cell_ids, gene_ids, inv_density: int,
              cells_true: int, genes_true: int) -> torch.Tensor:
    """``mask_block`` with the validity clamps: padded cells and genes are
    never held out."""
    m = mask_block(mask_seed, cell_ids, gene_ids, inv_density)
    return m & (cell_ids < cells_true)[:, None] & \
        (gene_ids < genes_true)[None, :]


def sweep_cap(tols, tol_target: float, masked: bool, fast: int = 8,
              fast_masked: int = 32, max_sweeps: int = 100) -> float:
    """The sweep cap of the step that follows the tols ``tols`` (the fit's
    trace so far), compared in float32."""
    thresh = max(np.float32(10.0) * np.float32(tol_target), np.float32(1e-4))
    exact = any(np.float32(t) <= thresh for t in [1.0] + list(tols))
    return float(max_sweeps if exact else (fast_masked if masked else fast))


def quantize(P: torch.Tensor, q_max: int, axis: int = 0):
    """(q, scales): per-pair symmetric quantization over ``axis``."""
    s = torch.clamp(P.abs().amax(dim=axis) / float(q_max), min=1e-30)
    sb = s[None, :] if axis == 0 else s[:, None]
    return torch.clamp(torch.round(P / sb), -q_max, q_max), s


def triu(k: int, device):
    i, j = np.triu_indices(k)
    return (torch.as_tensor(i, device=device), torch.as_tensor(j, device=device))


def pairs(X: torch.Tensor, iu) -> torch.Tensor:
    return X[:, iu[0]] * X[:, iu[1]]


def unpack(packed: torch.Tensor, k: int, iu) -> torch.Tensor:
    """(n, npairs) -> (n, k, k) symmetric."""
    out = torch.zeros((packed.shape[0], k, k), dtype=packed.dtype,
                      device=packed.device)
    out[:, iu[0], iu[1]] = packed
    out[:, iu[1], iu[0]] = packed
    return out


# ------------------------------------------------------------------ solver

def cd_nnls(a, B, X0, L1: float, cap: float, max_sweeps: int = 100,
            update_mask=None):
    """Coordinate-descent NNLS of every column (rows of B): ``a`` a shared
    (k, k) Gram or (n, k, k) Grams, B and X0 (n, k). Columns outside
    ``update_mask`` come back unchanged."""
    n, k = B.shape
    dt = B.dtype
    batched = a.dim() == 3
    inv = 1.0 / (torch.diagonal(a, dim1=1, dim2=2) if batched
                 else torch.diagonal(a))
    X = X0.to(dt).clone()
    R = B.clone()
    active = torch.ones(n, dtype=torch.bool, device=B.device)
    if update_mask is not None:
        active &= update_mask
    zero = torch.zeros((), dtype=dt, device=B.device)
    sweeps = 0
    while bool(active.any()):
        Xp = X.clone()
        for i in range(k):
            x_i = X[:, i]
            diff = R[:, i] * (inv[:, i] if batched else inv[i]) - L1
            delta = torch.where(active, torch.maximum(diff, -x_i), zero)
            R -= delta[:, None] * (a[:, :, i] if batched else a[:, i][None, :])
            X[:, i] = x_i + delta
        tol = torch.sum(torch.abs(X - Xp) / (X + 1e-15), dim=1)
        sweeps += 1
        active &= tol / k > CD_TOL
        if sweeps >= max_sweeps or not sweeps < cap:
            break
    return X


def cor_distance(x: torch.Tensor, y: torch.Tensor, prec: Precision) -> float:
    """1 - Pearson correlation over all entries of x and y, the tol of an
    ALS step (W against the W it started from): centred sums in
    ``prec.dtype``, the inputs rounded to ``prec.tol_inputs`` first."""
    if prec.tol_inputs is not None:
        x, y = x.to(prec.tol_inputs), y.to(prec.tol_inputs)
    x = x.reshape(-1).to(prec.dtype)
    y = y.reshape(-1).to(prec.dtype)
    x, y = x - x.mean(), y - y.mean()
    return float(1.0 - (x @ y) / torch.sqrt((x @ x) * (y @ y)))


def gram(X: torch.Tensor, prec: Precision) -> torch.Tensor:
    g = mm(X.T, X, prec).to(prec.dtype)
    return g + 1e-15 * torch.eye(g.shape[0], dtype=g.dtype, device=g.device)


# ------------------------------------------------------------ the operand

class DenseOperand:
    """A dense (genes_pad, cells_pad) float32 operand."""

    def __init__(self, A: torch.Tensor, genes_true: int, cells_true: int):
        self.A = A
        self.genes_true, self.cells_true = genes_true, cells_true
        self.genes_pad, self.cells_pad = A.shape
        self.cell_nonempty = (A != 0).any(dim=0)
        self.gene_nonempty = (A != 0).any(dim=1)

    def cells_block(self, cells: torch.Tensor, dtype) -> torch.Tensor:
        """A[:, cells] (genes_pad, len(cells))."""
        return self.A[:, cells].to(dtype)

    def genes_block(self, genes: torch.Tensor, c0: int, c1: int,
                    dtype) -> torch.Tensor:
        """A[genes, c0:c1] (len(genes), c1 - c0)."""
        return self.A[genes, c0:c1].to(dtype)


class EllOperand:
    """Blocked-ELL planes (n_gb * width, cells) of a genes x cells operand."""

    def __init__(self, b_li, b_val, gene_block: int, genes_true: int,
                 cells_true: int, genes_pad: int, chunk: int = 32768):
        self.b_li, self.b_val = b_li, b_val
        self.gene_block = gene_block
        self.genes_true, self.cells_true = genes_true, cells_true
        self.genes_pad, self.cells_pad = genes_pad, b_li.shape[1]
        self.width = b_li.shape[0] // (genes_pad // gene_block)
        dev = b_li.device
        rows = torch.arange(b_li.shape[0], device=dev)
        self.cell_nonempty = torch.zeros(self.cells_pad, dtype=torch.bool,
                                         device=dev)
        self.gene_nonempty = torch.zeros(genes_pad, dtype=torch.bool,
                                         device=dev)
        for c0 in range(0, self.cells_pad, chunk):
            li = b_li[:, c0:c0 + chunk]
            live = li >= 0
            self.cell_nonempty[c0:c0 + chunk] = live.any(dim=0)
            self.gene_nonempty[self._genes(rows, li)[live]] = True

    def _genes(self, rows, li):
        return (rows // self.width)[:, None] * self.gene_block + li.long()

    def cells_block(self, cells: torch.Tensor, dtype) -> torch.Tensor:
        li, lv = self.b_li[:, cells], self.b_val[:, cells]
        out = torch.zeros((self.genes_pad, len(cells)), dtype=dtype,
                          device=li.device)
        rows = torch.arange(li.shape[0], device=li.device)
        gene = self._genes(rows, li)
        col = torch.arange(len(cells), device=li.device)[None, :].expand_as(li)
        live = li >= 0
        out.index_put_((gene[live], col[live]), lv[live].to(dtype),
                       accumulate=True)
        return out

    def genes_block(self, genes: torch.Tensor, c0: int, c1: int,
                    dtype) -> torch.Tensor:
        return self.cells_block(torch.arange(c0, c1, device=genes.device),
                                dtype)[genes]


# ------------------------------------------------------------ the step

@dataclasses.dataclass
class StepSpec:
    """What a step solves: penalties, sweep cap, and for a masked step the
    mask's seed and density, the quantization blocks of the w-side mask
    products (0: one block) and whether the mask products are quantized."""

    L1_h: float
    L1_w: float
    cap: float
    max_sweeps: int = 100
    masked: bool = False
    mask_seed: int = 0
    inv_density: int = 20
    quantized: bool = False
    h_quant_block: int = 0


def _mask(op, spec: StepSpec, cells, genes):
    return test_mask(spec.mask_seed, cells, genes, spec.inv_density,
                     op.cells_true, op.genes_true)


def h_half(op, W, H_warm, cells, spec: StepSpec, prec: Precision,
           block: int = 2048):
    """The unnormalised h-side solve of the sampled ``cells`` against W
    (genes_pad, k): (len(cells), k) in ``prec.dtype``."""
    k = W.shape[1]
    dt = prec.dtype
    dev = W.device
    genes = torch.arange(op.genes_pad, device=dev)
    a = gram(W, prec)
    if spec.masked:
        iu = triu(k, dev)
        Pw = pairs(W.to(torch.float32), iu)
        if spec.quantized:
            q, s = quantize(Pw, prec.q_max, axis=0)
            Pw = q * s[None, :]
    grams, rhs = [], []
    for c0 in range(0, len(cells), block):
        cb = cells[c0:c0 + block]
        Ab = op.cells_block(cb, torch.float32)              # (genes, nb)
        if spec.masked:
            m = _mask(op, spec, cb, genes)                  # (nb, genes)
            Ab = torch.where(m.T, 0.0, Ab)
            corr = mm(m.to(torch.float32), Pw, prec).to(dt)
            grams.append(a[None] - unpack(corr, k, iu))
        rhs.append(mm(Ab.T, W, prec).to(dt))
    ab = torch.cat(grams) if spec.masked else a
    return cd_nnls(ab, torch.cat(rhs), H_warm[cells].to(dt), spec.L1_h,
                   spec.cap, spec.max_sweeps, op.cell_nonempty[cells])


def w_half(op, H, W_warm, genes, spec: StepSpec, prec: Precision,
           block: int = 2048):
    """The unnormalised w-side solve of the sampled ``genes`` against the
    normalised H (cells_pad, k): (len(genes), k) in ``prec.dtype``. The
    quantized mask products are quantized per ``h_quant_block`` cells."""
    k = H.shape[1]
    dt = prec.dtype
    dev = H.device
    a = gram(H, prec)
    ng = len(genes)
    Bw = torch.zeros((ng, k), dtype=dt, device=dev)
    iu = triu(k, dev) if spec.masked else None
    corr = torch.zeros((ng, len(iu[0])), dtype=dt, device=dev) \
        if spec.masked else None
    qb = spec.h_quant_block or op.cells_pad
    for c0 in range(0, op.cells_pad, block):
        c1 = min(c0 + block, op.cells_pad)
        cells = torch.arange(c0, c1, device=dev)
        Ab = op.genes_block(genes, c0, c1, torch.float32)   # (ng, nb)
        Hb = H[c0:c1]
        if spec.masked:
            m = _mask(op, spec, cells, genes).T             # (ng, nb)
            Ab = torch.where(m, 0.0, Ab)
            Ph = pairs(Hb.to(torch.float32), iu)
            if spec.quantized:
                for q0 in range(0, c1 - c0, qb):
                    q, s = quantize(Ph[q0:q0 + qb], prec.q_max, axis=0)
                    corr += mm(m[:, q0:q0 + qb].to(torch.float32), q,
                               prec).to(dt) * s[None, :].to(dt)
            else:
                corr += mm(m.to(torch.float32), Ph, prec).to(dt)
        Bw += mm(Ab, Hb, prec).to(dt)
    aw = a[None] - unpack(corr, k, iu) if spec.masked else a
    return cd_nnls(aw, Bw, W_warm[genes].to(dt), spec.L1_w, spec.cap,
                   spec.max_sweeps, op.gene_nonempty[genes])


def test_mse(op, W, d, H, mask_seed: int, inv_density: int,
             prec: Precision, block: int = 2048) -> float:
    """Held-out test MSE (reference:src/singlet.cpp:536-568): per cell the
    squared error summed over its held-out genes over their count (cells
    with none add 0), averaged over the true cells."""
    dev = W.device
    Wd = W.to(torch.float64) * d.to(torch.float64)[None, :]
    genes = torch.arange(op.genes_pad, device=dev)
    total = 0.0
    for c0 in range(0, op.cells_pad, block):
        cells = torch.arange(c0, min(c0 + block, op.cells_pad), device=dev)
        m = test_mask(mask_seed, cells, genes, inv_density, op.cells_true,
                      op.genes_true)
        pred = mm(H[cells], Wd.T, prec).to(torch.float64)   # (nb, genes)
        A = op.cells_block(cells, torch.float64).T
        s = torch.where(m, torch.square(pred - A), 0.0).sum(dim=1)
        n = m.sum(dim=1)
        total += float(torch.where(n > 0, s / n.clamp(min=1), 0.0).sum())
    return total / op.cells_true

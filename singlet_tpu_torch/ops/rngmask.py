"""Counter-based RNG for the speckled cross-validation masks.

Port of ``singlet_tpu/ops/rngmask.py``: membership of entry (cell i, gene j)
in the test set is a stateless xorshift64-style hash of (seed, i, j)
(reference:src/singlet.cpp:30-95), recomputed identically by the training
update and the test-MSE evaluation. It must be bit-exact.

This torch has no shifts, add or remainder for ``torch.uint64``, and ``>>``
on ``int64`` is an arithmetic shift. So the JAX package's representation is
kept: a 64-bit lane is a (hi, lo) pair of 32-bit halves, each held in an
``int64`` tensor in [0, 2^32) and masked with ``& 0xFFFFFFFF`` after every
shift and add. Values stay non-negative and below 2^63, so no operation
relies on signed wraparound, and the same code runs on the CPU and on the
card.

Convention: the mask is keyed (i = cell index, j = gene index) whatever the
orientation of the operand; ``mask[i, j] == True`` means entry (gene j,
cell i) is held out of training.
"""

from __future__ import annotations

from typing import Tuple

import torch

_M32 = 0xFFFFFFFF
U64 = Tuple[torch.Tensor, torch.Tensor]


def u64_from_int(x: int) -> U64:
    """Split a Python int (mod 2^64) into (hi, lo) int64 scalar tensors."""
    x = int(x) & ((1 << 64) - 1)
    return (torch.tensor(x >> 32, dtype=torch.int64),
            torch.tensor(x & _M32, dtype=torch.int64))


def u64_xor(a: U64, b: U64) -> U64:
    return a[0] ^ b[0], a[1] ^ b[1]


def u64_shl(a: U64, s: int) -> U64:
    """Left shift by a static amount s (0 <= s < 64)."""
    hi, lo = a
    if s == 0:
        return hi, lo
    if s < 32:
        return ((hi << s) | (lo >> (32 - s))) & _M32, (lo << s) & _M32
    return (lo << (s - 32)) & _M32, torch.zeros_like(lo)


def u64_shr(a: U64, s: int) -> U64:
    """Logical right shift by a static amount s (0 <= s < 64); the halves
    are non-negative, so ``>>`` on int64 shifts in zeros."""
    hi, lo = a
    if s == 0:
        return hi, lo
    if s < 32:
        return hi >> s, ((lo >> s) | (hi << (32 - s))) & _M32
    return torch.zeros_like(hi), hi >> (s - 32)


def u64_add(a: U64, b: U64) -> U64:
    lo = a[1] + b[1]
    return (a[0] + b[0] + (lo >> 32)) & _M32, lo & _M32


def u64_mod_small(a: U64, d: int) -> torch.Tensor:
    """a mod d for a small static modulus d (d < 2^16), exact:
    (hi * 2^32 + lo) % d == ((hi % d) * (2^32 % d) + lo % d) % d."""
    hi, lo = a
    return ((hi % d) * ((1 << 32) % d) + lo % d) % d


def _xs(a: U64, shifts) -> U64:
    """A sequence of xor-shift steps: ('l'|'r', amount)."""
    for direction, s in shifts:
        shifted = u64_shl(a, s) if direction == "l" else u64_shr(a, s)
        a = u64_xor(a, shifted)
    return a


# The three mixing stages of the reference's stateless hash
# (reference:src/singlet.cpp:30-64):
#   rand(i):    i ^= i<<19; i ^= i>>7; i ^= i<<36;  x = state + i;
#               x ^= x<<38; x ^= x>>13; x ^= x<<23
#   rand(i,j):  x = rand(i);  j ^= j>>7; j ^= j<<23; j ^= j>>8;  x += j;
#               x ^= x>>7;  x ^= x<<53; x ^= x>>4
_I_MIX = (("l", 19), ("r", 7), ("l", 36))
_X_MIX = (("l", 38), ("r", 13), ("l", 23))
_J_MIX = (("r", 7), ("l", 23), ("r", 8))
_XJ_MIX = (("r", 7), ("l", 53), ("r", 4))


def hash_i(seed_hi, seed_lo, i: U64) -> U64:
    """rand(i): mix cell index i (a (hi, lo) pair) into the seed."""
    i = _xs(i, _I_MIX)
    return _xs(u64_add((seed_hi, seed_lo), i), _X_MIX)


def hash_ij(seed_hi, seed_lo, i: U64, j: U64) -> U64:
    """rand(i, j): the full stateless hash of (seed, cell i, gene j)."""
    x = hash_i(seed_hi, seed_lo, i)
    return _xs(u64_add(x, _xs(j, _J_MIX)), _XJ_MIX)


def _ids_to_u64(ids: torch.Tensor) -> U64:
    lo = ids.to(torch.int64) & _M32
    return torch.zeros_like(lo), lo


def mask_block(seed: torch.Tensor, cell_ids: torch.Tensor,
               gene_ids: torch.Tensor, inv_density: int) -> torch.Tensor:
    """The speckled test-set mask of a (cells x genes) tile.

    seed: int64 (2,) (hi, lo) from :func:`seed_pair`; cell_ids (C,) and
    gene_ids (G,): global indices, on the device the mask is built on;
    inv_density: 1 / test-set density. Returns bool (C, G), True = held out.
    The per-cell stage of the hash is computed once per cell and broadcast
    over genes.
    """
    seed_hi, seed_lo = int(seed[0]), int(seed[1])
    xi = hash_i(seed_hi, seed_lo, _ids_to_u64(cell_ids))
    jm = _xs(_ids_to_u64(gene_ids), _J_MIX)
    x = u64_add((xi[0][:, None], xi[1][:, None]),
                (jm[0][None, :], jm[1][None, :]))
    return u64_mod_small(_xs(x, _XJ_MIX), int(inv_density)) == 0


def seed_pair(seed: int) -> torch.Tensor:
    """A Python integer seed as the int64 (2,) (hi, lo) pair, on the CPU
    (``mask_block`` reads it as two host integers)."""
    hi, lo = u64_from_int(seed)
    return torch.stack([hi, lo])


def mask_fraction(seed: int, n_cells: int, n_genes: int,
                  inv_density: int) -> float:
    """Measured density of the mask on a full grid (diagnostic helper)."""
    m = mask_block(seed_pair(seed), torch.arange(n_cells),
                   torch.arange(n_genes), inv_density)
    return float(m.float().mean())

"""The bits route's pair operands on the CPU: ``maskgram.quantized_pairs``
(the dispatcher of ``csrc/quantized_pairs.cu``) and its plain version, the
launch plan and a model of the kernel's arithmetic, and the pair tables
kept on the device (``linalg.triu_pairs_on``).

The kernel itself needs a card (``tests/test_torch_pairs_cuda.py``). Here:
the plain version writes ``quantize_pairs(packed_outer_products(X, iu))``
(bf16: the rounded products, unit scales) into the rows of a K-major view
or a pair buffer and one column of a group's scales, and nothing else; a
walk of the kernel's loops over ``pairs_plan`` writes each (pair, row) and
each scale once; and a float32 model of the kernel's quantization (the
multiply by the pair's reciprocal, the divide near a tie) gives the bits of
the divide, ties and zero columns included.
"""

import numpy as np
import pytest
import torch

from singlet_tpu_torch.ops import linalg, maskgram, maskgram_cuda
from singlet_tpu_torch.ops.linalg import packed_outer_products, triu_pairs

KS = [1, 2, 37, 100]
NS = [1, 1000, 2048]


def _rows(rng, n, k):
    """(n, k) float32 non-negative rows with a zero column (the scale's
    floor) and, for k > 2, a column of tiny values."""
    X = rng.random((n, k)).astype(np.float32) * 3
    X[:, k // 2] = 0.0
    if k > 2:
        X[:, 1] *= np.float32(1e-20)
    return torch.as_tensor(X)


def _chain(X, mode):
    P = packed_outer_products(X, triu_pairs(X.shape[1]))
    if mode == "int8":
        return maskgram.quantize_pairs(P, axis=0)
    return P.to(torch.bfloat16), torch.ones(P.shape[1])


@pytest.mark.parametrize("mode", ["int8", "bf16"])
@pytest.mark.parametrize("n", NS)
@pytest.mark.parametrize("k", KS)
def test_plain_writes_its_rows_and_scale_column(mode, n, k):
    """Rows [off, off + n) of a group operand in the engine's layout and
    column f of the group's scales get the eager chain's values; every
    other entry of both keeps what it held."""
    rng = np.random.default_rng(100 * k + n)
    X = _rows(rng, n, k)
    npairs = k * (k + 1) // 2
    F, f, off = 3, 1, n
    make = maskgram.kmajor_buffer if mode == "int8" else maskgram.pair_buffer
    buf = make(F * n, npairs, "cpu")
    dtype = torch.int8 if mode == "int8" else torch.bfloat16
    buf.copy_(torch.as_tensor(rng.integers(-100, 100, (F * n, npairs)))
              .to(dtype))
    scales = torch.as_tensor(rng.random((npairs, F)).astype(np.float32))
    buf0, scales0 = buf.clone(), scales.clone()
    out, s = maskgram.quantized_pairs(X, buf[off:off + n], scales[:, f])
    assert out.data_ptr() == buf[off:off + n].data_ptr()
    assert s.data_ptr() == scales[:, f].data_ptr()
    q, qs = _chain(X, mode)
    assert torch.equal(buf[off:off + n], q)
    assert torch.equal(scales[:, f], qs)
    keep = torch.ones(F * n, dtype=torch.bool)
    keep[off:off + n] = False
    assert torch.equal(buf[keep], buf0[keep])
    assert torch.equal(scales[:, [0, 2]], scales0[:, [0, 2]])
    if mode == "int8" and k > 1:
        zero = triu_pairs(k)[0] == k // 2
        assert torch.all(scales[torch.as_tensor(zero), f] == np.float32(1e-30))


@pytest.mark.parametrize("mode", ["int8", "bf16"])
def test_cuda_wrapper_on_cpu_runs_plain(mode):
    """The kernel's wrapper sends CPU tensors to the plain version, which
    counts a plain call, and counts no launch."""
    X = _rows(np.random.default_rng(5), 300, 9)
    make = maskgram.kmajor_buffer if mode == "int8" else maskgram.pair_buffer
    out = make(300, 45, "cpu")
    scales = torch.empty(45)
    launches, calls = maskgram_cuda.LAUNCHES_PAIRS, maskgram.PLAIN_CALLS
    maskgram_cuda.quantized_pairs_cuda(X, out, scales)
    assert maskgram_cuda.LAUNCHES_PAIRS == launches
    assert maskgram.PLAIN_CALLS == calls + 1
    q, qs = _chain(X, mode)
    assert torch.equal(out, q) and torch.equal(scales, qs)


def test_plain_refuses_other_types():
    with pytest.raises(TypeError, match="int8 or bfloat16"):
        maskgram.quantized_pairs(torch.ones(4, 2), torch.empty(4, 3),
                                 torch.empty(3))


@pytest.mark.parametrize("k", [1, 5, 100, 600])
def test_triu_pairs_on_is_cached_per_k_and_device(k):
    """The device's pair tables equal ``triu_pairs(k)`` as int64 and are
    made once per (k, device)."""
    i, j = linalg.triu_pairs_on(k, "cpu")
    iu = triu_pairs(k)
    assert i.dtype == j.dtype == torch.int64
    np.testing.assert_array_equal(i.numpy(), iu[0])
    np.testing.assert_array_equal(j.numpy(), iu[1])
    again = linalg.triu_pairs_on(k, torch.device("cpu"))
    assert again[0] is i and again[1] is j
    other = linalg.triu_pairs_on(k + 1, "cpu")
    assert other[0] is not i and other[0].shape[0] == (k + 1) * (k + 2) // 2


def _row_base(i, k):
    return i * k - i * (i - 1) // 2 - i


@pytest.mark.parametrize("n,k", [(1, 1), (7, 2), (300, 2), (1000, 37),
                                 (2048, 100), (2049, 40), (5000, 17),
                                 (16384, 20), (640, 600)])
def test_plan_walk_writes_each_pair_and_row_once(n, k):
    """A walk of the kernel's loops (block -> tile and slice, chunks of
    staged rows, a warp's rows of the tile, its columns from the diagonal
    on) over ``pairs_plan(n, k)``: every (pair, row) and every scale is
    written exactly once, at the packed index of ``triu_pairs``; the
    slices start on multiples of 128 and a cluster has at most 8 blocks."""
    plan = maskgram_cuda.pairs_plan(n, k)
    T, C = maskgram_cuda.PAIRS_TILE, maskgram_cuda.PAIRS_CHUNK
    iu = triu_pairs(k)
    npairs = iu[0].shape[0]
    assert plan.nt * T >= k > (plan.nt - 1) * T
    assert 1 <= plan.cs <= maskgram_cuda.PAIRS_MAX_CLUSTER
    assert plan.slice % 128 == 0 and plan.cs * plan.slice >= n
    assert plan.tiles * plan.cs < 2**31
    pos = np.array([_row_base(i, k) + j for i, j in zip(*iu)])
    np.testing.assert_array_equal(pos, np.arange(npairs))
    rows = np.zeros((npairs, n), np.int32)
    scales = np.zeros(npairs, np.int32)
    for blk in range(plan.tiles * plan.cs):
        rank, t, ti = blk % plan.cs, blk // plan.cs, 0
        while t >= plan.nt - ti:
            t -= plan.nt - ti
            ti += 1
        i0, j0 = ti * T, (ti + t) * T
        if rank == 0:
            for e in range(T * T):
                i, j = i0 + e // T, j0 + e % T
                if i <= j < k:
                    scales[_row_base(i, k) + j] += 1
        r0 = rank * plan.slice
        r1 = min(n, r0 + plan.slice)
        for c0 in range(r0, r1, C):
            cn = min(C, r1 - c0)
            for ii in range(T):
                i = i0 + ii
                if i >= k:
                    break
                for jj in range(max(0, i - j0), min(T, k - j0)):
                    rows[_row_base(i, k) + j0 + jj, c0:c0 + cn] += 1
    assert (rows == 1).all() and (scales == 1).all()


def _quant_model(P, s):
    """The kernel's quantization of float32 P (cells, pairs) with scales
    s (pairs,) in float32: y = P * rcp (rcp the rounded reciprocal), its
    integer half to even by adding 1.5 * 2^23, kept where y lies at least
    2^-14 from a half-integer; elsewhere clamp(rint(P / s))."""
    with np.errstate(all="ignore"):
        rcp = np.float32(1) / s
        y = (P * rcp).astype(np.float32)
        f = (y + np.float32(12582912.0)).astype(np.float32)
        t = (f - np.float32(12582912.0)).astype(np.float32)
        ok = np.abs(y - t) < np.float32(0.5 - 2.0**-14)
        fast = np.clip(f.view(np.int32) - 0x4B400000, -127, 127)
        slow = np.clip(np.rint(P / s), -127, 127)
        slow = np.where(np.isnan(slow), 0, slow).astype(np.int32)
    return np.where(ok, fast, slow).astype(np.int8), ok


def _cuda_scale(P):
    """The scale the card's chain forms: amax times the float reciprocal of
    127, floored at 1e-30."""
    s = np.abs(P).max(axis=0) * (np.float32(1) / np.float32(127))
    return np.maximum(s.astype(np.float32), np.float32(1e-30))


def test_quant_model_gives_the_divides_bits():
    """The model against clamp(round(P / s)) in float32 on random products,
    values within a few ulps of every tie m + 1/2 (negative ones too), a
    zero column and tiny ones: the same int8 everywhere, the divide taken
    near the ties and almost nowhere else."""
    rng = np.random.default_rng(11)
    cells, npairs = 4096, 40
    P = (rng.standard_normal((cells, npairs)) * 5).astype(np.float32)
    P[:, 3] = 0.0
    P[:, 4] *= np.float32(1e-30)
    P[:, 5] *= np.float32(1e-38)        # subnormal products
    # ties: pair p >= 6 holds its max 100 in row 0, then (m + 1/2) s and
    # the values 1-3 ulps above and 1-2 below it, for every m in range
    m = np.arange(-127, 127, dtype=np.float32)
    for p in range(6, npairs):
        P[:, p] = 0.0
        P[0, p] = np.float32(100.0) + np.float32(p)
        s_p = _cuda_scale(P[:, p:p + 1])[0]
        up = [((m + np.float32(0.5)) * s_p).astype(np.float32)]
        down = [up[0]]
        for _ in range(3):
            up.append(np.nextafter(up[-1], np.float32(np.inf)))
        for _ in range(2):
            down.append(np.nextafter(down[-1], np.float32(-np.inf)))
        vals = np.concatenate(up + down[1:])
        vals = vals[np.abs(vals) < P[0, p]]
        P[1:1 + vals.shape[0], p] = vals
    s = _cuda_scale(P)
    got, ok = _quant_model(P, s)
    want = torch.clamp(torch.round(torch.as_tensor(P) / torch.as_tensor(s)),
                       -127, 127).to(torch.int8).numpy()
    np.testing.assert_array_equal(got, want)
    assert ok[:, :6].mean() > 0.999
    assert (~ok[:, 6:]).sum() > 1000

"""The bits route's pair operands on the card: ``quantized_pairs_cuda``
(``singlet_tpu_torch/ops/maskgram_cuda.py``, source
``csrc/quantized_pairs.cu``) against the eager chain it replaced, and the
ELL engine's bits-route masked step with the kernel against the same step
with that chain.

A CUDA kernel has no CPU mode, so every test here needs a card and skips
without one. On a machine with a card (and without jax, which
``tests/conftest.py`` imports), run:

    python -m pytest --noconftest tests/test_torch_pairs_cuda.py -q

Tolerance: none. The kernel forms each product, the per-pair max, the
scale, the divide, the rounding and the clamp as PyTorch's CUDA ops do, so
q, the scales and the bf16 products must be the same bits as
``quantize_pairs(packed_outer_products(X, iu), axis=0)`` (bf16:
``packed_outer_products(X, iu).to(torch.bfloat16)``) on the card, and the
engine's step the same W, H, d and tol.
"""

import numpy as np
import pytest
import torch

from singlet_tpu_torch.ops import maskgram, maskgram_cuda
from singlet_tpu_torch.ops.linalg import triu_pairs

pytestmark = pytest.mark.cuda

KS = [1, 2, 37, 100, 128, 600]
NS = [1, 1000, 2048, 16384]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: quantized_pairs has no CPU mode")
    return torch.device("cuda")


def _cuda_scale(amax):
    """The scale the card's chain forms from a max: times the float
    reciprocal of 127."""
    return np.float32(amax) * (np.float32(1) / np.float32(127))


def _rows(n, k, seed, device):
    """(n, k) float32 rows: U(0, 3) with some negative values, a zero
    column (the scale's floor) for k >= 3, and for k >= 2 column 0 all ones
    and the other columns' rows 1.. on and beside the rounding ties m + 1/2
    of their pair with column 0 (row 0 holds the max)."""
    rng = np.random.default_rng(seed)
    X = (rng.random((n, k)) * 3).astype(np.float32)
    X[rng.random((n, k)) < 0.05] *= -1
    if k >= 2:
        X[:, 0] = 1.0
        m = np.arange(-127, 127, dtype=np.float32)
        for j in range(1, k):
            X[0, j] = np.float32(50.0 + j % 50)
            s = _cuda_scale(X[0, j])
            up = [((m + np.float32(0.5)) * s).astype(np.float32)]
            down = [up[0]]
            for _ in range(2):
                up.append(np.nextafter(up[-1], np.float32(np.inf)))
                down.append(np.nextafter(down[-1], np.float32(-np.inf)))
            vals = np.concatenate(up + down[1:])
            vals = rng.permutation(vals[np.abs(vals) < X[0, j]])[:n - 1]
            X[1:1 + vals.shape[0], j] = vals
            X[1 + vals.shape[0]:, j] = np.clip(X[1 + vals.shape[0]:, j],
                                               -X[0, j], X[0, j])
    if k >= 3:
        X[:, k - 1] = 0.0
    return torch.as_tensor(X, device=device)


def _eager(X, mode, pairs_per_call=None):
    """The eager chain on X's device, over the pairs in calls of at most
    ``pairs_per_call`` (each pair's values and scale depend on its column
    alone, so the calls give the bits of one): (n, npairs) and (npairs,)."""
    k = X.shape[1]
    iu = triu_pairs(k)
    npairs = iu[0].shape[0]
    step = pairs_per_call or npairs
    qs, ss = [], []
    for p0 in range(0, npairs, step):
        i = torch.as_tensor(iu[0][p0:p0 + step], device=X.device)
        j = torch.as_tensor(iu[1][p0:p0 + step], device=X.device)
        P = X[:, i] * X[:, j]
        if mode == "int8":
            q, s = maskgram.quantize_pairs(P, axis=0)
        else:
            q, s = P.to(torch.bfloat16), torch.ones(P.shape[1],
                                                    device=X.device)
        qs.append(q)
        ss.append(s)
    return torch.cat(qs, dim=1), torch.cat(ss)


def _buffer(mode, rows, npairs, device):
    make = maskgram.kmajor_buffer if mode == "int8" else maskgram.pair_buffer
    return make(rows, npairs, device)


@pytest.mark.parametrize("mode", ["int8", "bf16"])
@pytest.mark.parametrize("n", NS)
@pytest.mark.parametrize("k", KS)
def test_kernel_same_bits_as_eager_chain(cuda, mode, n, k):
    """q and the scales (int8) or the bf16 products, in the engine's
    layouts, equal the eager chain on the card bit for bit; one launch."""
    X = _rows(n, k, 1000 * k + n, cuda)
    npairs = k * (k + 1) // 2
    out = _buffer(mode, n, npairs, cuda)
    scales = torch.empty(npairs, device=cuda)
    launches = maskgram_cuda.LAUNCHES_PAIRS
    maskgram_cuda.quantized_pairs_cuda(X, out, scales)
    torch.cuda.synchronize()
    assert maskgram_cuda.LAUNCHES_PAIRS == launches + 1
    q, s = _eager(X, mode, pairs_per_call=max(1, (1 << 27) // n))
    assert torch.equal(scales, s)
    assert out.dtype == q.dtype
    bad = (out.view(torch.int16 if mode == "bf16" else torch.int8)
           != q.view(torch.int16 if mode == "bf16" else torch.int8))
    assert not bool(bad.any()), (
        f"{int(bad.sum())} of {bad.numel()} values differ, first at "
        f"{torch.nonzero(bad)[:4].tolist()}")


@pytest.mark.parametrize("mode", ["int8", "bf16"])
@pytest.mark.parametrize("off", [3, 1000, 2048])
@pytest.mark.parametrize("k", [37, 100])
def test_kernel_writes_its_rows_and_scale_column(cuda, mode, off, k):
    """Rows [off, off + n) of a group operand and column f of the group's
    (npairs, F) scales get the chain's values; every other entry of both
    keeps what it held. Offset 3 leaves the rows unaligned for 4-byte
    stores."""
    n, F, f = 2048, 3, 2
    X = _rows(n, k, 7 + k + off, cuda)
    npairs = k * (k + 1) // 2
    buf = _buffer(mode, off + n + 100, npairs, cuda)
    g = torch.Generator(device=cuda).manual_seed(off)
    fill = torch.randint(-100, 100, buf.shape, device=cuda, generator=g)
    buf.copy_(fill.to(buf.dtype))
    scales = torch.rand((npairs, F), device=cuda, generator=g)
    buf0, scales0 = buf.clone(), scales.clone()
    maskgram_cuda.quantized_pairs_cuda(X, buf[off:off + n], scales[:, f])
    q, s = _eager(X, mode)
    assert torch.equal(buf[off:off + n], q)
    assert torch.equal(scales[:, f], s)
    keep = torch.ones(buf.shape[0], dtype=torch.bool, device=cuda)
    keep[off:off + n] = False
    assert torch.equal(buf[keep], buf0[keep])
    others = [c for c in range(F) if c != f]
    assert torch.equal(scales[:, others], scales0[:, others])


def test_kernel_refuses_what_it_does_not_take(cuda):
    X = torch.rand((64, 5), device=cuda)
    s = torch.empty(15, device=cuda)
    with pytest.raises(ValueError, match="kmajor_buffer"):
        maskgram_cuda.quantized_pairs_cuda(
            X, torch.empty((64, 15), dtype=torch.int8, device=cuda), s)
    with pytest.raises(ValueError, match="pair_buffer"):
        maskgram_cuda.quantized_pairs_cuda(
            X, torch.empty((15, 64), dtype=torch.bfloat16,
                           device=cuda).T, s)
    with pytest.raises(ValueError, match="float32"):
        maskgram_cuda.quantized_pairs_cuda(
            X.double(), maskgram.kmajor_buffer(64, 15, cuda), s)
    with pytest.raises(ValueError, match="rows and columns"):
        maskgram_cuda.quantized_pairs_cuda(
            X[:0], maskgram.kmajor_buffer(0, 15, cuda), s)
    with pytest.raises(ValueError, match="scales"):
        maskgram_cuda.quantized_pairs_cuda(
            X, maskgram.kmajor_buffer(64, 15, cuda), s[:14])


def _engine_step(cuda, monkeypatch, route):
    """A bits-route masked step of the ELL engine on the card (k = 37, 4
    blocks of 2048 cells, 700 genes) as a function of nothing, and the
    number of blocks. ``route``: int8, bf16 or mask8 (int8 with
    SINGLET_TPU_MASK8=1); read when the step is built."""
    import scipy.sparse as sp

    from singlet_tpu_torch.ops.rngmask import seed_pair
    from singlet_tpu_torch.parallel import sharded_ell as tell

    monkeypatch.setenv("SINGLET_TPU_MASKGRAM",
                       "bf16" if route == "bf16" else "int8")
    monkeypatch.setenv("SINGLET_TPU_MASK8", "1" if route == "mask8" else "0")
    A = sp.random(700, 8192, density=0.05, random_state=5, format="csc",
                  dtype=np.float32)
    eng = tell.ShardedEllEngine(A, device=cuda, cell_block=2048,
                                gene_block=256)
    fns = tell._build_local_fns(eng.data, 10)
    assert fns["use_bits"]()
    k = 37
    w0 = np.random.default_rng(3).random((700, k)).astype(np.float32)
    W, H = eng._state(k, w0, 0)
    sp_ = seed_pair(4)
    bits = fns["prepare_bits"](sp_)
    W, H, _, _ = fns["masked"](W, H, sp_, 0.01, 0.01, 0.0, 0.0, k,
                               bits=bits)   # a start with H from the data

    def step():
        return fns["masked"](W, H, sp_, 0.01, 0.01, 0.0, 0.0, k,
                             sweep_cap=8.0, bits=bits)
    return step, eng.data.cells_local // 2048


@pytest.mark.parametrize("route", ["int8", "bf16", "mask8"])
def test_engine_step_same_bits_as_eager_chain(cuda, monkeypatch, route):
    """The step with the kernel gives W, H, d and tol bit for bit those of
    the same step with the eager chain (the plain version, run on the
    card), with one launch a block and one for W and no plain call; the
    chain's step counts a plain call for each of them."""
    from singlet_tpu_torch.parallel import sharded_ell as tell

    step, blocks = _engine_step(cuda, monkeypatch, route)
    launches, calls = maskgram_cuda.LAUNCHES_PAIRS, maskgram.PLAIN_CALLS
    got = step()
    torch.cuda.synchronize()
    assert maskgram_cuda.LAUNCHES_PAIRS == launches + blocks + 1
    assert maskgram.PLAIN_CALLS == calls
    monkeypatch.setattr(tell, "quantized_pairs",
                        maskgram.quantized_pairs_plain)
    want = step()
    assert maskgram_cuda.LAUNCHES_PAIRS == launches + blocks + 1
    assert maskgram.PLAIN_CALLS == calls + blocks + 1
    for name, a, b in zip(("W", "H", "d", "tol"), got, want):
        assert torch.equal(a, b), name


@pytest.mark.parametrize("route", ["int8", "mask8"])
def test_engine_step_never_syncs(cuda, monkeypatch, route):
    """Once its pair tables and row starts are on the card (the first
    step), a bits-route step makes no call that waits for the card."""
    step, _ = _engine_step(cuda, monkeypatch, route)
    step()
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        out = step()
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    assert torch.isfinite(out[0]).all()

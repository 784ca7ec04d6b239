"""Kernel B1's host plan and the order of its sweep tolerance
(``singlet_tpu_torch/ops/nnls_cuda.py`` ``b1_plan``, ``csrc/nnls_cd.cu``),
and the port's ``solve_nnls`` with a per-coordinate L1, on the CPU.

The CUDA kernel runs only on a card (``tests/test_torch_nnls_cuda.py``).
What surrounds it is checked here: the plan covers every column once,
keeps at most 16 coordinates a lane (8 at an odd pitch) and fits in a
Hopper block's 232,448 bytes of shared memory for every n >= 1 and k <=
224, and takes the device-memory route past it; a numpy model of the kernel's tolerance sum (a lane's
partials of the parent's lanes p, p + G, ... in step order, the parent's
xor butterfly split into adds inside the lane for offsets >= G and across
the group below) gives, bit for bit, the parent's 32-lane sum, for every
G, on float32 terms with zeros and denormals; and the port's
``solve_nnls`` with a shared Gram and an (n, k) L1 agrees with the JAX
package's (its XLA loop) at rtol = 5e-3, atol = 1e-6, the tolerance of
tests/test_pallas_nnls.py (the sweep-end tol is summed in another order).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from singlet_tpu.ops import nnls as jnnls
from singlet_tpu_torch.ops import nnls as tnnls
from singlet_tpu_torch.ops.nnls_cuda import (MAX_K, MAX_K_SHARED, WidePlan,
                                             b1_plan)

SMEM = 232448
GS = (1, 2, 4, 8, 16, 32)
KS = (1, 3, 10, 31, 33, 50, 100, 224, 300, 512)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One torch intra-op thread in this module: the suite runs one worker
    process per core, and a thread pool per worker oversubscribes them."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


NS = (1, 2, 7, 31, 32, 33, 255, 1500, 4096, 8192, 16384, 32767, 524288)


@pytest.mark.parametrize("k", [1, 2, 9, 16, 17, 32, 33, 50, 64, 65, 100,
                               128, 129, 200, 208, 209, 223, 224, 225, 256,
                               300, 320, 321, 480, 511, 512])
def test_b1_plan_covers_every_column_once(k):
    """G lanes a column, a power of two from 2; columns a warp 32 / G; the
    column sets cover 0..n-1 once (column = set * cols + group); each lane
    holds ceil(k / G) <= 16 coordinates (8 at an odd pitch) p, p + G,
    ..., which cover 0..k-1
    once over the G lanes; a plan is a function of (n, k)."""
    for n in NS:
        plan = b1_plan(n, k)
        assert plan == b1_plan.__wrapped__(n, k)
        assert plan.g in GS[1:] and plan.cols * plan.g == 32
        assert plan.npl <= 16 and plan.g * plan.npl >= k
        if plan.shared and plan.pitch % 2:
            assert plan.npl <= 8   # scalar loads: at most 8 a lane
        cols = [s * plan.cols + grp for s in range(plan.warps)
                for grp in range(plan.cols)]
        assert sorted(c for c in cols if c < n) == list(range(n))
        assert plan.warps * plan.cols - n < plan.cols
        coords = sorted(t * plan.g + p for p in range(plan.g)
                        for t in range(plan.npl) if t * plan.g + p < k)
        assert coords == list(range(k))


@pytest.mark.parametrize("k", range(1, MAX_K_SHARED + 1))
def test_b1_plan_fits_shared_memory(k):
    """For every k <= 224 and any n the staged Gram (k + 1 rows of G *
    pitch floats), the 8 warps' sweep terms and L1 and 1/diag fit in a
    block's shared memory; at an odd pitch the
    lanes of a group read distinct banks, at a pitch of 4 mod 8 (16-byte
    loads, npl >= 4) the 8 lanes of a quarter-warp read distinct groups
    of 4 banks."""
    for n in NS:
        plan = b1_plan(n, k)
        assert plan.shared
        assert plan.smem == ((k + 1) * plan.g * plan.pitch
                             + 17 * 32 * plan.npl) * 4 <= SMEM
        if plan.pitch % 2:
            assert plan.pitch >= plan.npl and plan.npl <= 8
            banks = {(p * plan.pitch) % 32 for p in range(plan.g)}
            assert len(banks) == plan.g
        else:
            assert plan.pitch % 8 == 4 and plan.pitch >= plan.npl >= 4
            quads = {(p * plan.pitch) % 32 // 4 for p in range(min(plan.g, 8))}
            assert len(quads) == min(plan.g, 8)


@pytest.mark.parametrize("k", range(MAX_K_SHARED + 1, MAX_K + 1, 7))
def test_b1_plan_device_memory_route_past_224(k):
    """Past k = 224: G = 32, one column a warp, the transposed Gram from
    device memory in rows of 32 npl floats (npl even, 8..16)."""
    plan = b1_plan(1000, k)
    assert not plan.shared and plan.smem == 17 * 32 * plan.npl * 4
    assert plan.g == 32 and plan.npl % 2 == 0 and 8 <= plan.npl <= 16
    assert 32 * plan.npl >= k and plan.pitch == 32 * plan.npl


def test_b1_plan_fills_the_card():
    """The bench's and the 524k operand's calls get at least 1024 warps,
    with the fewest lanes a column that allow it; past k = 512 it takes
    the wide-k route."""
    assert b1_plan(8192, 50).g == 4 and b1_plan(8192, 50).warps >= 1024
    assert b1_plan(16384, 50).g == 4
    assert b1_plan(524288, 100).g == 8 and b1_plan(16384, 100).g == 8
    assert b1_plan(1500, 10).warps >= 1024
    assert isinstance(b1_plan(10, MAX_K + 1), WidePlan)


def _f32(x):
    return np.float32(x)


def _parent_tol(terms):
    """The parent's sum: lane l adds the terms of coordinates l, l + 32,
    ... in order, then the xor butterfly 16 .. 1 (every lane ends with the
    same value; lane 0's)."""
    k = len(terms)
    lane = [_f32(0)] * 32
    for i in range(k):
        lane[i % 32] = _f32(lane[i % 32] + terms[i])
    off = 16
    while off:
        lane = [_f32(lane[l] + lane[l ^ off]) for l in range(32)]
        off //= 2
    assert len({float(v) for v in lane}) == 1
    return lane[0]


def _kernel_tol(terms, g):
    """The kernel's sum for G = g: lane p of a group holds coordinates
    j g + p in register j; register j belongs to the parent's lane p + g
    (j mod 32 / g); the partials are summed in register order, the
    butterfly's offsets >= g inside the lane, below g across the group
    (every lane of the group ends with the same value)."""
    k, r = len(terms), 32 // g
    npl = -(-k // g)
    results = []
    lane_val = []
    for p in range(g):
        term = [terms[j * g + p] if j * g + p < k else _f32(0)
                for j in range(npl)]
        part = [_f32(0)] * r
        for j in range(npl):
            part[j % r] = _f32(part[j % r] + term[j])
        m = r // 2
        while m:
            part = [_f32(part[i] + part[i + m]) for i in range(m)]
            m //= 2
        lane_val.append(part[0])
    off = g // 2
    while off:
        lane_val = [_f32(lane_val[p] + lane_val[p ^ off]) for p in range(g)]
        off //= 2
    results = {float(v) for v in lane_val}
    assert len(results) == 1
    return lane_val[0]


def _terms(rng, k):
    """Non-negative float32 tolerance terms: zeros, denormals, the clamp
    term's huge values and ordinary ones."""
    kind = rng.integers(0, 4, k)
    t = np.where(kind == 0, 0.0,
                 np.where(kind == 1, rng.random(k) * 1e-40,
                          np.where(kind == 2, rng.random(k) * 1e15,
                                   rng.random(k)))).astype(np.float32)
    return [_f32(v) for v in t]


@pytest.mark.parametrize("k", KS)
@pytest.mark.parametrize("g", GS)
def test_tolerance_order_is_the_parents(g, k):
    """For every G the kernel's split butterfly gives the parent's 32-lane
    sum bit for bit (float32 addition commutes; each level adds the same
    two values)."""
    rng = np.random.default_rng(1000 * g + k)
    for _ in range(20):
        terms = _terms(rng, k)
        want = _parent_tol(terms)
        got = _kernel_tol(terms, g)
        assert np.float32(got).tobytes() == np.float32(want).tobytes()


def test_tolerance_model_sees_a_changed_order():
    """The bitwise check can fail: adding the same terms in one plain
    left-to-right chain gives other bits on some input."""
    rng = np.random.default_rng(5)
    differ = 0
    for _ in range(50):
        terms = _terms(rng, 100)
        chain = _f32(0)
        for t in terms:
            chain = _f32(chain + t)
        differ += np.float32(chain).tobytes() != \
            np.float32(_parent_tol(terms)).tobytes()
    assert differ > 0


@pytest.mark.parametrize("n,k", [(256, 9), (300, 50), (64, 230)])
@pytest.mark.parametrize("sweep_cap", [None, 8.0])
def test_solve_nnls_l1_array_matches_jax(rng, n, k, sweep_cap):
    """The port's solve_nnls with a shared Gram and an (n, k) L1 (the plain
    version's per-coordinate branch; on a card kernel B1) against the JAX
    package's solve_nnls, which runs its XLA loop for it."""
    F = rng.random((max(64, 2 * k), k)).astype(np.float32)
    a = (F.T @ F + 1e-15 * np.eye(k)).astype(np.float32)
    B = (rng.random((n, F.shape[0])) @ F).astype(np.float32)
    X0 = (rng.random((n, k)) * (rng.random((n, k)) < 0.5)).astype(np.float32)
    L1 = (rng.random((n, k)) * 0.05).astype(np.float32)
    mask = rng.random(n) < 0.9
    kw = dict(L2=0.001, sweep_cap=sweep_cap)
    got = tnnls.solve_nnls(*(torch.as_tensor(x) for x in (a, B, X0)),
                           L1=torch.as_tensor(L1),
                           update_mask=torch.as_tensor(mask), **kw).numpy()
    want = np.asarray(jnnls.solve_nnls(
        *(jnp.asarray(x) for x in (a, B, X0)), L1=jnp.asarray(L1),
        update_mask=jnp.asarray(mask), **kw))
    np.testing.assert_allclose(got, want, rtol=5e-3, atol=1e-6)
    np.testing.assert_array_equal(got[~mask], X0[~mask])

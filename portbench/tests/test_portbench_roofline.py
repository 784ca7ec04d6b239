"""The roofline arithmetic: each input byte and each output byte counted
once, operations from what the inputs need, and a kernel's share taken
against the work of its call, whatever kernel computes it."""

import types

import pytest
import torch

from portbench import devtrace, roofline
from portbench import registry
from conftest import BENCH_DIR


def test_spmm_counts_each_byte_once():
    # 64 slot rows x 100 cells of int32 ids and float32 values, W 1024 x 8
    # read, B 100 x 8 written, 2 k operations a stored entry
    nbytes, ops = roofline.spmm(64, 100, 5000, 8, 1024)
    assert nbytes == 8 * 64 * 100 + 4 * 1024 * 8 + 4 * 100 * 8
    assert ops == 2 * 5000 * 8
    # the test words of the masked products add 4 bytes a word, once
    nb2, ops2 = roofline.spmm(64, 100, 5000, 8, 1024, word_cols=16)
    assert nb2 - nbytes == 4 * 100 * 16 and ops2 == ops


def test_mask_gemm_counts_each_byte_once():
    nbytes, ops = roofline.mask_gemm_w(512, 55, 64, 16, 300)
    assert nbytes == 512 * 55 + 4 * 55 + 4 * 64 * 16 + 4 * 55 * 64
    assert ops == 2 * 300 * 55
    nbytes, ops = roofline.mask_gemm_h(256, 55, 2, 16, 512, 400)
    assert nbytes == 256 * 55 + 4 * 55 * 2 + 4 * 256 * 16 + 8 * 55 * 512
    assert ops == 2 * 400 * 55


def test_bound_is_the_larger_of_bytes_and_operations():
    assert roofline.bound_s(3.35e12, 0, "f32") == pytest.approx(1.0)
    assert roofline.bound_s(0, 67e12, "f32") == pytest.approx(1.0)
    assert roofline.bound_s(3.35e12, 2 * 1979e12, "int8") == \
        pytest.approx(2.0)


def _call(label, li, x, **kw):
    meta = devtrace._meta
    args = [meta(li, True), meta(li.float()), meta(x)]
    if label in ("B5", "B6"):
        args.append(meta(torch.zeros(li.shape[1], 16, dtype=torch.int32)))
    return devtrace.KernelCall(label, args, kw, None, None, ms=1.0)


def _run(calls, seconds):
    kernels = devtrace.KernelCalls()
    kernels.calls = calls
    profile = types.SimpleNamespace(seconds=lambda *labels: seconds,
                                    busy_s=seconds, window_s=2 * seconds)
    return types.SimpleNamespace(kernels=kernels, profile=profile,
                                 config={"genes": 1024},
                                 workload={"args": {}})


def test_spmm_share_is_against_the_call_not_the_kernel():
    li = torch.full((64, 100), -1, dtype=torch.int32)
    li[:40] = 3                                   # 4000 stored entries
    W = torch.zeros(1024, 8)
    read = registry.metric_module(BENCH_DIR, "spmm_roofline.iter").read
    need = roofline.bound_s(*roofline.spmm(64, 100, 4000, 8, 1024), "f32")
    share_b3 = read(_run([_call("B3", li, W, gene_block=512)], 1e-3))
    assert share_b3 == pytest.approx(100 * need / 1e-3)
    # B4 over the same planes, reading H and writing the genes' rows, is
    # the same work
    H = torch.zeros(100, 8)
    share_b4 = read(_run([_call("B4", li, H, gene_block=512, n_gb=2)],
                         1e-3))
    assert share_b4 == pytest.approx(share_b3)
    # twice the device time, half the share
    assert read(_run([_call("B3", li, W)], 2e-3)) == \
        pytest.approx(share_b3 / 2)
    # nothing to read: no share, not 0
    assert read(_run([], 1e-3)) is None


def test_readers_without_a_device_trace_read_nothing():
    run = types.SimpleNamespace(kernels=None, profile=None, calls=[],
                                t_end=0.0)
    for name in ("spmm_roofline.iter", "maskgemm_roofline.masked",
                 "idle_share.fit", "nnls_share.fit"):
        assert registry.metric_module(BENCH_DIR, name).read(run) is None


def test_every_per_layer_metric_has_a_reader_and_its_layer():
    import json
    import os

    with open(os.path.join(os.path.dirname(BENCH_DIR),
                           "BENCHMARK.json")) as f:
        bench = json.load(f)
    e2e = {m["name"]: m for m in bench["end_to_end"]}
    for m in bench["per_layer"]:
        mod = registry.metric_module(BENCH_DIR, m["name"])
        assert mod.LAYER == m["layer"] and mod.UNIT == m["unit"]
        assert m["moves"] in e2e
        moved = e2e[m["moves"]].get("workloads")
        if moved is not None:
            assert set(m["workloads"]) <= set(moved)

"""The bits route's mask products' share of their roofline: B8 and B9,
each with its pass. The least time their calls need
(``roofline.mask_gemm_w`` / ``mask_gemm_h``: the quantized pair operand
and its scales, the test words, the corrections written or the carry read
and written, each once; two int8 operations a held-out entry and pair,
the held-out entries counted at the configuration's test density) over
their device time (the profiler's rows of their kernels and passes)."""

from portbench import roofline

LAYER = "kernels"
UNIT = "%"


def read(run):
    if run.kernels is None:
        return None
    calls = run.kernels.by_label("B8", "B9")
    if not calls:
        return None
    density = float(run.workload["args"].get("test_density", 0.05))
    genes_true = int(run.config["genes"])
    need = 0.0
    for c in calls:
        P, words = c.args[0]["shape"], c.args[2]["shape"]
        op_bytes = 1 if "int8" in c.args[0]["dtype"] else 2
        if c.label == "B8":
            genes_pad, npairs = P
            cells = words[0]
            nbytes, ops = roofline.mask_gemm_w(
                genes_pad, npairs, cells, words[1],
                cells * genes_true * density, op_bytes)
        else:
            cells, npairs = P
            genes_pad = c.args[3]["shape"][1]
            groups = cells // int(c.kwargs.get("scale_block") or cells)
            nbytes, ops = roofline.mask_gemm_h(
                cells, npairs, groups, words[1], genes_pad,
                cells * genes_true * density, op_bytes)
        need += roofline.bound_s(nbytes, ops,
                                 "int8" if op_bytes == 1 else "bf16")
    took = run.profile.seconds("B8", "B9")
    return 100.0 * need / took if took > 0 else None

"""The blocked-ELL products' share of their roofline: B3 and B4 (a plain
step), or B5 and B6 (a masked step on the bits route), whichever the cell
runs. The least time their calls need (``roofline.spmm``: the planes, the
test words, the factor read and the product written each counted once,
two operations a stored entry and factor) over their device time (the
profiler's rows of their kernels, and the CUDA-event time of calls that
have no row)."""

from portbench import devtrace, roofline

LAYER = "kernels"
UNIT = "%"


def read(run):
    if run.kernels is None:
        return None
    calls = run.kernels.by_label("B3", "B4", "B5", "B6")
    if not calls:
        return None
    nnz_of = {}
    need = 0.0
    for c in calls:
        li = c.args[0]
        key = (li["view"].data_ptr(), li["shape"])
        if key not in nnz_of:
            nnz_of[key] = devtrace.live(li["view"])
        rows, cells = li["shape"]
        x = c.args[2]["shape"]                  # W (genes_pad, k) or H
        k = x[1]
        if c.label in ("B3", "B5"):
            genes_pad = x[0]
        else:
            genes_pad = c.kwargs["gene_block"] * c.kwargs["n_gb"]
        words = c.args[3]["shape"][1] if c.label in ("B5", "B6") else 0
        nbytes, ops = roofline.spmm(rows, cells, nnz_of[key], k, genes_pad,
                                    words)
        need += roofline.bound_s(nbytes, ops, "f32")
    took = run.profile.seconds(*{c.label for c in calls})
    return 100.0 * need / took if took > 0 else None

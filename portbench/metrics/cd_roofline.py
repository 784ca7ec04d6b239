"""The CD-NNLS solves' share of their roofline: B1 and B2. Their least
time over their device time (the profiler's rows of their kernels).

Operations, from the kernels' own counters on the window's ``iteration``
events, by route, at the k of each iteration's fit (its ``fit_start``):
2 k^2 a column and sweep (each of a sweep's k steps downdates k residuals
by one multiply and one subtract) and 2 k^2 a column for its start
gradient. Bytes, from the shapes of the B1 and B2 calls the window
recorded: the Gram (B1, B2's packed entry's a_full) or the per-column
Grams (B2's tile, or its packed entry's corrections) read once, B and X0
read, and X written, all float32. Each route's least time is the larger
of its bytes over the memory rate and its operations over the float32
peak (``roofline.bound_s``). A program without the counters, or a window
without B1 or B2, gives nothing."""

from portbench import roofline

LAYER = "kernels"
UNIT = "%"
ROUTES = ("B1", "B2")


def gram_bytes(call) -> int:
    """Bytes of a B1 or B2 call's Gram operands and of B, X0 and X."""
    shapes = [a["shape"] for a in call.args if isinstance(a, dict)]
    n, k = shapes[-2]                          # B (n, k), then X0
    grams = shapes[:2] if call.label == "B2" and len(shapes) == 4 \
        else shapes[:1]
    floats = sum(_size(s) for s in grams) + 3 * n * k
    return 4 * floats


def _size(shape) -> int:
    out = 1
    for d in shape:
        out *= d
    return out


def read(run):
    if run.kernels is None or run.profile is None:
        return None
    k_of = {e["fit"]: e["k"] for c in run.calls for e in c.events
            if e["event"] == "fit_start"}
    ops = dict.fromkeys(ROUTES, 0.0)
    counted = False
    for c in run.calls:
        for e in c.events:
            if e["event"] == "iteration" and "cd_sweeps" in e \
                    and e["t"] <= run.t_end:
                k = k_of.get(e["fit"])
                if k is None:
                    continue
                for r in ROUTES:
                    ops[r] += 2.0 * k * k * (e["cd_sweeps"][r]
                                             + e["cd_columns"][r])
                counted = True
    nbytes = dict.fromkeys(ROUTES, 0)
    for call in run.kernels.by_label(*ROUTES):
        nbytes[call.label] += gram_bytes(call)
    took = run.profile.seconds(*ROUTES)
    if not counted or took <= 0:
        return None
    need = sum(roofline.bound_s(nbytes[r], ops[r], "f32") for r in ROUTES)
    return 100.0 * need / took

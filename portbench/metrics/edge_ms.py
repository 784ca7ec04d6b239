"""Per fit, the host time at the fit's edge on the program's own spans:
``singlet.output`` (the factors copied to the host, which waits for the
card) and ``singlet.finalize`` (the driver's sort by d, or its CV frame).
The mean over the driver calls of the window whose output span it holds,
in ms; a program without these spans gives nothing."""

LAYER = "drivers"
UNIT = "ms"
NAMES = ("singlet.output", "singlet.finalize")


def read(run):
    per_call = {}
    for c in run.calls:
        for e in c.events:
            if e["event"] == "span" and e["name"] in NAMES \
                    and e["t"] <= run.t_end:
                ms, outputs = per_call.get(e["call"], (0.0, 0))
                per_call[e["call"]] = (
                    ms + e["ms"], outputs + (e["name"] == NAMES[0]))
    vals = [ms for ms, outputs in per_call.values() if outputs]
    return sum(vals) / len(vals) if vals else None

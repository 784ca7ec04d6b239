"""Per fit, the time from the benchmark's call of the driver to the start
of the fit's first iteration: routing, the init, and a masked fit's pack
of the test mask. The mean over the window's calls, in ms (host clock:
the call's time, and the first ``iteration`` event less that iteration's
own ``ms``)."""

LAYER = "drivers"
UNIT = "ms"


def read(run):
    vals = []
    for c in run.calls:
        its = [e for e in c.events if e["event"] == "iteration"]
        if its:
            vals.append((its[0]["t"] - c.t_call) * 1e3 - its[0]["ms"])
    return sum(vals) / len(vals) if vals else None

"""Iterations a fit ran, from the ``fit_end`` event's exact ``n_iter``:
the mean over the fits the window called (the last of which may end after
the window has closed)."""

LAYER = "fit loops"
UNIT = "iters"


def read(run):
    n = [e["n_iter"] for c in run.calls for e in c.events
         if e["event"] == "fit_end"]
    return sum(n) / len(n) if n else None

"""Per iteration, the host time of the step's dispatch on the program's
own ``singlet.step`` span: the Python and launch work of one ALS step,
which returns before the card has run it (the iteration's one sync is the
``singlet.sync`` span after it). The mean over the window's steps, in ms.
Read in the traced run, so it holds the profiler's cost a host operation;
a program without the span gives nothing."""

LAYER = "fit loops"
UNIT = "ms"


def read(run):
    ms = [e["ms"] for c in run.calls for e in c.events
          if e["event"] == "span" and e["name"] == "singlet.step"
          and e["t"] <= run.t_end]
    return sum(ms) / len(ms) if ms else None

"""CD-NNLS sweeps a column: the sweeps that the solves of the window's
iterations ran, over the columns they solved (B1 and B2 together), from
the kernels' own counters as the ``iteration`` events carry them
(``cd_sweeps`` and ``cd_columns``, by route). A program without the
counters gives nothing."""

LAYER = "kernels"
UNIT = "sweeps"


def read(run):
    sweeps = columns = 0
    for c in run.calls:
        for e in c.events:
            if e["event"] == "iteration" and "cd_sweeps" in e \
                    and e["t"] <= run.t_end:
                sweeps += sum(e["cd_sweeps"].values())
                columns += sum(e["cd_columns"].values())
    return sweeps / columns if columns else None

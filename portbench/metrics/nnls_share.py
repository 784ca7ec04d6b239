"""Kernels B1 and B2 (the CD-NNLS solves), by the profiler's rows of
their kernels, as a share of the device's busy time."""

LAYER = "device"
UNIT = "%"


def read(run):
    if run.profile is None:
        return None
    s = run.profile.seconds("B1", "B2")
    busy = run.profile.busy_s
    return 100.0 * s / busy if s > 0 and busy > 0 else None

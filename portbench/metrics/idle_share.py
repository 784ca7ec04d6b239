"""The device's idle share of the traced window: 1 - busy / wall, with the
profiler's kernel time and the CUDA-event time of the kernels its rows
miss (B3, B7) as busy time."""

LAYER = "device"
UNIT = "%"


def read(run):
    p = run.profile
    if p is None:
        return None
    return 100.0 * (1.0 - p.busy_s / p.window_s) if p.window_s > 0 else None

"""Seconds per complete fit to the cell's tolerance, fits run back to
back: the window, from the first fit's call to the end of the last fit
that ended in it, over the number of those fits."""

BOUNDARY = "fit"


def value(span_s: float, count: int) -> float:
    return span_s / count

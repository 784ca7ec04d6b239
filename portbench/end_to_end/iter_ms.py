"""Milliseconds per plain ALS iteration over back-to-back fits: the
window, closed at the first iteration that ends past its length, over
the iterations that ended in it (each fit's set-up and its copy of W, d,
H to the host inside)."""

BOUNDARY = "iteration"


def value(span_s: float, count: int) -> float:
    return span_s * 1e3 / count

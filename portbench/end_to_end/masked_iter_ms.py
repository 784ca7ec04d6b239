"""Milliseconds per masked iteration of a rank search over back-to-back
fits: the window, closed at the first iteration that ends past its
length, over the iterations that ended in it (each fit's pack, init and
traced test errors inside)."""

BOUNDARY = "iteration"


def value(span_s: float, count: int) -> float:
    return span_s * 1e3 / count

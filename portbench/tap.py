"""What the benchmark reads from the program while the window runs.

* ``Events``: a ``MetricLogger`` installed with ``set_metric_logger`` that
  stamps each event (``fit_start``, ``iteration``, ``fit_end``) with the
  host's monotonic clock as it is logged; an ``iteration`` event is logged
  after the iteration's own sync, so the iteration has ended on the card.
* ``StepTap``: wraps the ``step`` that the program's fit loops call once
  per iteration (``solvers.als._fit_loop`` and the engine's copy of it;
  ``solvers.ard.run_ard`` and the engine's copy, with their ``mse``), and
  keeps references to the inputs and outputs of a fit's first and last
  step, and to the states whose test errors the judge recomputes: the
  newest, the one before it, and the one of the least error logged so far
  (so those of the fit's last traced iteration, of its tail trace and of
  its least error, which decide where a masked fit stopped). It copies
  nothing and syncs nothing, so the window pays only a Python call per
  iteration.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable, Dict, List, Optional

from singlet_tpu_torch import tracing
from singlet_tpu_torch.parallel import sharded_ell
from singlet_tpu_torch.solvers import als, ard


class Events(tracing.MetricLogger):
    """The program's metric events in memory, each with ``t``, the
    ``time.perf_counter()`` at which it was logged. ``watch(deadline, fn)``
    calls ``fn`` once, at the first ``iteration`` event at or past the
    deadline: the iteration that closes the window."""

    def __init__(self) -> None:
        super().__init__(path=None, keep_in_memory=True)
        self._watch = None

    def watch(self, deadline: float, fn: Callable) -> None:
        self._watch = (deadline, fn)

    def log(self, event: str, fit: Optional[str] = None, **fields: Any) -> None:
        t = time.perf_counter()
        super().log(event, fit=fit, t=t, **fields)
        if self._watch is not None and event == "iteration" \
                and t >= self._watch[0]:
            fn, self._watch = self._watch[1], None
            fn()


@dataclasses.dataclass
class StepRecord:
    """One step: its inputs W, H and outputs W, H, d, tol (tensors)."""

    W_in: Any
    H_in: Any
    W: Any
    H: Any
    d: Any
    tol: Any


@dataclasses.dataclass
class FitRecord:
    steps: int = 0
    first: Optional[StepRecord] = None
    last: Optional[StepRecord] = None
    # test MSE calls so far, and (W, d, H) of those kept, by call index
    n_mse: int = 0
    mse_states: Dict[int, tuple] = dataclasses.field(default_factory=dict)


class StepTap:
    """``events``: the ``Events`` the fits log to, whose ``test_mse``
    fields say which test-MSE state holds the least error so far."""

    def __init__(self, events: Events) -> None:
        self.events = events
        self.fits: List[FitRecord] = []
        self._saved = []

    def _wrap(self, step, mse=None):
        rec = FitRecord()
        self.fits.append(rec)
        n_ev = len(self.events.events)

        def tapped(W, H, cap):
            out = step(W, H, cap)
            r = StepRecord(W, H, *out)
            rec.steps += 1
            if rec.first is None:
                rec.first = r
            rec.last = r
            return out

        def tapped_mse(W, d, H):
            n = rec.n_mse
            errs = [e["test_mse"] for e in self.events.events[n_ev:]
                    if e["event"] == "iteration" and "test_mse" in e]
            keep = {n - 1, n}
            if errs:
                keep.add(min(range(len(errs)), key=errs.__getitem__))
            rec.mse_states = {i: s for i, s in rec.mse_states.items()
                              if i in keep}
            rec.mse_states[n] = (W, d, H)
            rec.n_mse += 1
            return mse(W, d, H)
        return tapped, tapped_mse

    def take(self) -> List[FitRecord]:
        """The records of the fits since the last call."""
        fits, self.fits = self.fits, []
        return fits

    def install(self) -> None:
        for mod in (als, sharded_ell):
            orig = mod._fit_loop
            self._saved.append((mod, "_fit_loop", orig))

            def loop(step, *args, _orig=orig, **kwargs):
                return _orig(self._wrap(step)[0], *args, **kwargs)
            mod._fit_loop = loop
        for mod in (ard, sharded_ell):
            orig = mod.run_ard
            self._saved.append((mod, "run_ard", orig))

            def run(step, mse, *args, _orig=orig, **kwargs):
                return _orig(*self._wrap(step, mse), *args, **kwargs)
            mod.run_ard = run

    def remove(self) -> None:
        for mod, name, orig in reversed(self._saved):
            setattr(mod, name, orig)
        self._saved = []

"""Metric logging, spans, CD-NNLS sweep counters and profiler traces.

The twin of ``singlet_tpu/tracing.py``:

  * ``MetricLogger``: per-iteration JSONL event records (``ts``, ``fit``
    id, ``event`` and its fields), written line by line so that a crashed
    run leaves its trace up to the failure; in a ``torch.distributed``
    world rank 0 writes the file and every rank keeps its events in
    memory;
  * a process-wide default logger (``get_metric_logger``,
    ``set_metric_logger``, ``metric_logging``), so that the fits emit
    events without a logger argument: ``fit_start``, ``iteration`` and
    ``fit_end`` of every fit, and the ELL engine's ``bell_ingest``;
  * ``profile(logdir)``: a ``torch.profiler`` trace of the CPU and, where
    there is one, the card, written to ``logdir`` as a Chrome trace (the
    JAX package's wraps ``jax.profiler``).

Spans and counters, on while ``enabled()``: while a ``torch.profiler``
trace records (``profile(logdir)`` or any other), or while the installed
logger was made with ``spans=True`` (``metric_logging(path,
spans=True)``). Off, a span site costs that one check and the CD-NNLS
kernels get a null counter.

  * ``span(name)``: a profiler record function of that name, so that the
    span sits in the trace on the card's timeline as a host operation
    (not a user annotation, which the CUDA profiler mirrors as a device
    event over the span's kernels), and at its end
    a ``span`` event (``name``, ``parent``: the enclosing span's name,
    ``call``: the id of the outermost span, which the fits' ``fit_start``
    events carry too, and ``ms`` on the host's clock). With ``device``, a
    CUDA event pair times the span on the card as well: its event logs
    ``device_ms`` too, once the fit's output has reached the host
    (``output_span``), with no sync of its own. The spans, outermost
    first: ``singlet.driver`` (``run_nmf``, ``cross_validate_nmf``,
    ``ard_nmf``), ``singlet.setup`` (routing, the init and what a fit
    builds before its loop), ``singlet.pack`` (the engine's test mask
    packed into words, on the card too), ``singlet.iter`` (an iteration),
    ``singlet.step`` (the step's host dispatch), ``singlet.test_mse``,
    ``singlet.sync`` (the host waiting on the card for the tol),
    ``singlet.output`` (the factors copied to the host) and
    ``singlet.finalize`` (the drivers' sort by d and CV frame).
  * ``CdCounts``: the sweeps and columns of the CD-NNLS solves of one fit
    loop's iterations, by route (B1: one shared Gram, B2: a Gram a
    column), counted by the kernels (``ops/nnls_cuda.py``) or, on the CPU,
    by ``ops.nnls.nnls_batch``, and read inside the iteration's one sync:
    the ``iteration`` event carries ``cd_sweeps`` and ``cd_columns``, each
    ``{"B1": n, "B2": n}``.

Logging never raises into a fit: a failure is reported once and logging is
off for the rest of the run.
"""

from __future__ import annotations

import contextlib
import io
import json
import os
import threading
import time
import uuid
from typing import Any, Dict, List, Optional

import torch

__all__ = ["MetricLogger", "NULL_LOGGER", "get_metric_logger",
           "set_metric_logger", "metric_logging", "profile", "enabled",
           "span", "output_span", "call_fields", "CdCounts", "cd_counter"]


def _writes_files() -> bool:
    """Whether this process writes the metric log: rank 0 of an
    initialized ``torch.distributed`` world, or the only process. Every
    rank keeps its events in memory. The logger is process-wide and knows
    no mesh; the ``"cells"`` mesh spans the world (``make_mesh``), so this
    is the rank that writes a mesh fit's checkpoints (``solvers.als.
    save_once``)."""
    import torch.distributed as dist

    return not (dist.is_available() and dist.is_initialized()) \
        or dist.get_rank() == 0


class MetricLogger:
    """Append-only structured event log (JSONL) and in-memory event list.

    Each event is one JSON object per line:
    ``{"ts": <unix float>, "fit": <id>, "event": <name>, ...fields}``.
    Thread-safe. Installed with ``spans``, it turns the spans and the
    CD-NNLS counters on (``enabled``) without a profiler.
    """

    def __init__(self, path: Optional[str] = None,
                 keep_in_memory: bool = True, spans: bool = False) -> None:
        self.path = path
        self.keep_in_memory = keep_in_memory
        self.spans = bool(spans)
        self.events: List[Dict[str, Any]] = []
        self._lock = threading.Lock()
        self._fh: Optional[io.TextIOBase] = None
        self._broken = False
        if path is not None:
            os.makedirs(os.path.dirname(os.path.abspath(path)) or ".",
                        exist_ok=True)
            self._fh = open(path, "a", buffering=1)

    def new_fit_id(self, prefix: str = "fit") -> str:
        return f"{prefix}-{uuid.uuid4().hex[:8]}"

    def log(self, event: str, fit: Optional[str] = None, **fields: Any) -> None:
        if self._broken:
            return
        rec = {"ts": time.time(), "event": event}
        if fit is not None:
            rec["fit"] = fit
        rec.update(fields)
        try:
            with self._lock:
                if self.keep_in_memory:
                    self.events.append(rec)
                if self._fh is not None and _writes_files():
                    self._fh.write(json.dumps(rec) + "\n")
        except Exception as exc:  # never break the fit because of logging
            self._broken = True
            print(f"singlet_tpu_torch.tracing: metric logging disabled "
                  f"({exc!r})")

    def close(self) -> None:
        with self._lock:
            if self._fh is not None:
                self._fh.close()
                self._fh = None

    def __enter__(self) -> "MetricLogger":
        return self

    def __exit__(self, *exc: Any) -> None:
        self.close()


class _NullLogger(MetricLogger):
    """The default logger: ``log`` does nothing."""

    def __init__(self) -> None:
        super().__init__(path=None, keep_in_memory=False)

    def log(self, event: str, fit: Optional[str] = None, **fields: Any) -> None:
        pass


NULL_LOGGER = _NullLogger()
_current: MetricLogger = NULL_LOGGER


def get_metric_logger() -> MetricLogger:
    return _current


def set_metric_logger(logger: Optional[MetricLogger]) -> MetricLogger:
    """Install ``logger`` as the process-wide default; returns the previous
    one so that callers can restore it."""
    global _current
    prev = _current
    _current = logger if logger is not None else NULL_LOGGER
    return prev


@contextlib.contextmanager
def metric_logging(path: Optional[str] = None, keep_in_memory: bool = True,
                   spans: bool = False):
    """Scoped metric logging: a fresh ``MetricLogger`` is the default for
    the with-block, and the previous one is restored after it; with
    ``spans``, the spans and counters are on in it."""
    logger = MetricLogger(path=path, keep_in_memory=keep_in_memory,
                          spans=spans)
    prev = set_metric_logger(logger)
    try:
        yield logger
    finally:
        set_metric_logger(prev)
        logger.close()


@contextlib.contextmanager
def profile(logdir: str, enabled: bool = True):
    """A ``torch.profiler`` trace around a fit, CPU and CUDA activity (the
    card's where there is one), written to ``logdir`` as a Chrome trace
    (``chrome://tracing``, Perfetto, TensorBoard). A no-op when disabled,
    so callers can gate on a flag."""
    if not enabled:
        yield
        return
    import torch
    from torch.profiler import (ProfilerActivity, profile as _profile,
                                tensorboard_trace_handler)

    os.makedirs(logdir, exist_ok=True)
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with _profile(activities=activities,
                  on_trace_ready=tensorboard_trace_handler(logdir)):
        yield


# ---------------------------------------------------------------------------
# Spans and counters
# ---------------------------------------------------------------------------

_profiler_enabled = torch._C._autograd._profiler_enabled
# a record function of the FUNCTION scope, a plain host op of the trace:
# ``torch.profiler.record_function`` records a user annotation, which the
# CUDA profiler mirrors as a device event over the kernels launched inside
# it, so that a trace's device time would count every open span
_RecordFunction = torch._C._profiler._RecordFunctionFast


def enabled() -> bool:
    """Whether the spans and the CD-NNLS counters are on: while a
    ``torch.profiler`` trace records, or while the installed logger was
    made with ``spans=True``."""
    return _current.spans or _profiler_enabled()


class _State(threading.local):
    """A thread's open spans (innermost last), its device spans waiting
    for the card, and the counters armed for the current step."""

    def __init__(self) -> None:
        self.stack: List["_Span"] = []
        self.pending: List["_Span"] = []
        self.cd: Optional[torch.Tensor] = None


_state = _State()
_OFF = contextlib.nullcontext()


class _Span:
    def __init__(self, name: str, device) -> None:
        self.name = name
        self.device = device

    def __enter__(self) -> "_Span":
        stack = _state.stack
        outer = stack[-1] if stack else None
        self.parent = outer.name if outer is not None else None
        self.call = outer.call if outer is not None else \
            f"call-{uuid.uuid4().hex[:8]}"
        stack.append(self)
        self.rf = _RecordFunction(self.name)
        self.rf.__enter__()
        self.events = None
        if self.device is not None:
            self.events = (torch.cuda.Event(enable_timing=True),
                           torch.cuda.Event(enable_timing=True))
            self.events[0].record(torch.cuda.current_stream(self.device))
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc: Any) -> None:
        self.ms = round((time.perf_counter() - self.t0) * 1e3, 3)
        self.rf.__exit__(*exc)
        _state.stack.remove(self)
        self.logger = _current
        if self.events is None:
            self._log()
        else:
            self.events[1].record(torch.cuda.current_stream(self.device))
            _state.pending.append(self)

    def _log(self, **fields: Any) -> None:
        self.logger.log("span", name=self.name, parent=self.parent,
                        call=self.call, ms=self.ms, **fields)


def call_fields() -> Dict[str, str]:
    """``{"call": id}`` of the open spans' driver call, for a fit's
    ``fit_start`` event, or {} outside any span."""
    stack = _state.stack
    return {"call": stack[-1].call} if stack else {}


def span(name: str, device=None):
    """A context manager naming a layer of the port while ``enabled()``
    (else a no-op): a profiler record function ``name`` (a host op) and,
    at its end, a ``span`` event (``name``, ``parent``, ``call``, ``ms``).
    ``device``: a ``torch.device`` whose current CUDA stream the span also
    times with a pair of CUDA events; its event, with ``device_ms``, waits
    for the next ``output_span`` (a CPU device times nothing there)."""
    if not enabled():
        return _OFF
    dev = torch.device(device) if device is not None else None
    return _Span(name, dev if dev is not None and dev.type == "cuda"
                 else None)


@contextlib.contextmanager
def output_span():
    """The ``singlet.output`` span around a fit's copy of its factors to
    the host, which waits for the card; then the device spans whose CUDA
    events have completed log their events, with ``device_ms``, whether
    or not the spans are still on."""
    with span("singlet.output"):
        yield
    waiting = []
    for s in _state.pending:
        if s.events[1].query():
            s._log(device_ms=round(s.events[0].elapsed_time(s.events[1]),
                                   3))
        else:
            waiting.append(s)
    _state.pending = waiting


_ROUTES = ("B1", "B2")


def cd_counter(route: str, device) -> Optional[torch.Tensor]:
    """The (sweeps, columns) int64 accumulator of CD-NNLS ``route`` ("B1"
    or "B2") for a solve on ``device``: a view of the counters that a fit
    loop armed for its step (``CdCounts.armed``), or None while they are
    off, unarmed or on another device."""
    cd = _state.cd
    if cd is None or cd.device != device or not enabled():
        return None
    i = 2 * _ROUTES.index(route)
    return cd[i:i + 2]


class CdCounts:
    """The CD-NNLS sweeps and columns of one fit loop's iterations on
    ``device``, by route: ``armed()`` around an iteration's step arms a
    (4,) int64 tensor that the solves add to (``cd_counter``) while the
    counters are on; ``read`` syncs once, for the step's scalars and the
    counts together. A column counts once a solve, when its update mask
    lets it move; its sweeps are those it ran before it stopped."""

    def __init__(self, device) -> None:
        self.device = torch.device(device)
        self.total: Optional[torch.Tensor] = None
        self.seen = [0] * 4
        self.on = False

    @contextlib.contextmanager
    def armed(self):
        self.on = enabled()
        if not self.on:
            yield
            return
        if self.total is None:
            self.total = torch.zeros(4, dtype=torch.int64,
                                     device=self.device)
        _state.cd = self.total
        try:
            yield
        finally:
            _state.cd = None

    def read(self, *scalars: torch.Tensor):
        """(the 0-d float32 ``scalars`` as floats, the iteration event's
        ``cd_sweeps`` and ``cd_columns``, or {} where the last step was not
        counted), in one sync: with the counts, through float64, which
        holds each float32 and each count exactly."""
        if not self.on:
            if len(scalars) == 1:
                return [scalars[0].item()], {}
            return torch.stack(scalars).tolist(), {}
        vals = torch.cat([torch.stack(scalars).double(),
                          self.total.double()]).tolist()
        n = len(scalars)
        counts = [int(v) for v in vals[n:]]
        diff = [c - s for c, s in zip(counts, self.seen)]
        self.seen = counts
        self.on = False
        return vals[:n], dict(
            cd_sweeps={r: diff[2 * i] for i, r in enumerate(_ROUTES)},
            cd_columns={r: diff[2 * i + 1] for i, r in enumerate(_ROUTES)})

"""Metric logging and profiler traces.

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

__all__ = ["MetricLogger", "NULL_LOGGER", "get_metric_logger",
           "set_metric_logger", "metric_logging", "profile"]


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
    Thread-safe.
    """

    def __init__(self, path: Optional[str] = None,
                 keep_in_memory: bool = True) -> None:
        self.path = path
        self.keep_in_memory = keep_in_memory
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
def metric_logging(path: Optional[str] = None, keep_in_memory: bool = True):
    """Scoped metric logging: a fresh ``MetricLogger`` is the default for
    the with-block, and the previous one is restored after it."""
    logger = MetricLogger(path=path, keep_in_memory=keep_in_memory)
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

"""The traced run (``--trace 1``): device time by kernel, the device's busy
and idle time, and the calls of the hand-written kernels with their
shapes, taken from the benchmark's own files around the program's calls.

* ``torch.profiler`` over the window (started before it, stopped at the
  iteration or fit that closes it) gives each device operation's time,
  the device's busy time, and the idle gaps with the host operation
  running in each; the raw kineto events are read, which is much faster
  than the profiler's own tables on a window of a million events.
* Each wrapper of a kernel in ``ops/bell_cuda.py``, ``ops/maskgram_cuda.py``
  and ``ops/nnls_cuda.py`` is wrapped for the window: its calls' shapes
  are kept for the roofline readers, and CUDA events around each call
  time it. The events also bracket the wrapper's host work, so a kernel's
  time is the profiler's rows of its kernels; a call whose main kernel
  has no row (the profiler of an older torch showed none for B3 and B7)
  adds its event time to the busy time instead.
"""

from __future__ import annotations

import dataclasses
import importlib
import re
import sys
from typing import Any, Dict, List

import torch

# label -> (module, wrapper)
WRAPPERS = (
    ("B1", "singlet_tpu_torch.ops.nnls_cuda", "nnls_batch_cuda"),
    ("B2", "singlet_tpu_torch.ops.nnls_cuda",
     "nnls_batch_cuda_batched_packed_t"),
    ("B2", "singlet_tpu_torch.ops.nnls_cuda", "nnls_batch_cuda_batched_at"),
    ("B3", "singlet_tpu_torch.ops.bell_cuda", "bell_spmm_cuda"),
    ("B4", "singlet_tpu_torch.ops.bell_cuda", "bell_spmm_t_cuda"),
    ("B5", "singlet_tpu_torch.ops.bell_cuda", "bell_spmm_bits_cuda"),
    ("B6", "singlet_tpu_torch.ops.bell_cuda", "bell_spmm_t_bits_cuda"),
    ("B7", "singlet_tpu_torch.ops.bell_cuda", "bell_mse_bits_cuda"),
    ("B8", "singlet_tpu_torch.ops.maskgram_cuda",
     "mask_packed_w_t_bits_cuda"),
    ("B9", "singlet_tpu_torch.ops.maskgram_cuda",
     "mask_packed_h_t_bits_cuda"),
)
# label -> (its main kernel, one launch a call; its other kernels), as
# regular expressions over the profiler's kernel names (csrc/*.cu)
KERNELS = {
    "B1": (r"nnls_cd_kernel<", ()),
    "B2": (r"nnls_cd_col_kernel<", ()),
    "B3": (r"bell_spmm_kernel<[01]>|bell_spmm_wide_kernel<[01],", ()),
    "B4": (r"bell_spmm_t_kernel<\d+, [01]>", ()),
    "B5": (r"bell_spmm_kernel<2>|bell_spmm_wide_kernel<2,",
           (r"bell_words_t_kernel",)),
    "B6": (r"bell_spmm_t_kernel<\d+, 2>", ()),
    "B7": (r"b7_kernel<|b7_wide_kernel<", (r"b7_bits_kernel",)),
    "B8": (r"mask_gemm(_s8)?_kernel<false>", (r"gpack_words",)),
    "B9": (r"mask_gemm(_s8)?_kernel<true>", (r"kpack_words",)),
}


# the labels whose first argument, the planes' gene ids, the readers
# count stored entries of (the planes live for the whole run, so keeping
# the view costs nothing)
_PLANES = ("B3", "B4", "B5", "B6")


def _meta(x, keep: bool = False):
    """What a call's argument leaves for the readers: a tensor's shape and
    dtype (with ``keep``, the tensor itself), other values as they are."""
    if isinstance(x, torch.Tensor):
        return dict(shape=tuple(x.shape), dtype=str(x.dtype),
                    view=x if keep else None)
    return x


@dataclasses.dataclass
class KernelCall:
    label: str
    args: List[Any]
    kwargs: Dict[str, Any]
    start: Any
    end: Any
    ms: float = 0.0


class KernelCalls:
    """Between ``install()`` and ``finish()``, each kernel wrapper records a
    ``KernelCall`` while ``recording`` is set."""

    def __init__(self) -> None:
        self.calls: List[KernelCall] = []
        self.recording = False
        self._saved = []

    def install(self) -> None:
        for label, modname, attr in WRAPPERS:
            mod = importlib.import_module(modname)
            fn = getattr(mod, attr)
            self._saved.append((mod, attr, fn))

            def timed(*args, _fn=fn, _label=label, **kwargs):
                if not self.recording:
                    return _fn(*args, **kwargs)
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                start.record()
                out = _fn(*args, **kwargs)
                end.record()
                self.calls.append(KernelCall(
                    _label, [_meta(a, i == 0 and _label in _PLANES)
                             for i, a in enumerate(args)],
                    {k: _meta(v) for k, v in kwargs.items()}, start, end))
                return out
            setattr(mod, attr, timed)

    def finish(self) -> None:
        """Put the wrappers back and read the events' times."""
        for mod, attr, fn in reversed(self._saved):
            setattr(mod, attr, fn)
        self._saved = []
        self.recording = False
        torch.cuda.synchronize()
        for c in self.calls:
            c.ms = c.start.elapsed_time(c.end)
            c.start = c.end = None

    def by_label(self, *labels) -> List[KernelCall]:
        return [c for c in self.calls if c.label in labels]

    def seconds(self, *labels) -> float:
        return sum(c.ms for c in self.by_label(*labels)) / 1e3


def live(view: torch.Tensor) -> int:
    """Stored entries of a planes' ids view (pad -1)."""
    return int((view >= 0).sum())


@dataclasses.dataclass
class DeviceProfile:
    busy_s: float
    window_s: float
    rows: Dict[str, Any]    # kernel name -> (seconds, launches)
    missed: Dict[str, float]  # label -> event seconds the rows miss
    ops: List[Any]          # [[name, seconds], ...] by device time
    gaps: List[Any]         # [[host op, seconds], ...] longest first

    def seconds(self, *labels) -> float:
        """Device seconds of the labels' kernels: the profiler's rows of
        their kernels (each row once) and what the rows miss."""
        pats = [re.compile(p) for lab in labels
                for p in (KERNELS[lab][0],) + KERNELS[lab][1]]
        rows = sum(s for name, (s, _) in self.rows.items()
                   if any(p.search(name) for p in pats))
        return rows + sum(self.missed.get(lab, 0.0) for lab in labels)


def _missed(rows, calls: "KernelCalls") -> Dict[str, float]:
    """Per label, the share of its calls whose main kernel has no launch in
    the profiler's rows, at the calls' mean event time: the profiler has
    shown no row for some kernels on this card (B3 over all cells, B7)."""
    out = {}
    for label, (main, _) in KERNELS.items():
        mine = calls.by_label(label)
        if not mine:
            continue
        pat = re.compile(main)
        seen = sum(n for name, (_, n) in rows.items() if pat.search(name))
        lost = max(0, len(mine) - seen)
        if lost:
            out[label] = lost * sum(c.ms for c in mine) / len(mine) / 1e3
    return out


def _span_us(e):
    if hasattr(e, "start_ns"):
        return e.start_ns() / 1e3, e.duration_ns() / 1e3
    return e.start_us(), e.duration_us()


def _idle_gaps(kernels, host, window, top: int = 10):
    """The longest gaps between device operations in ``window`` (us), each
    named by the innermost host operation running at its middle."""
    gaps, t = [], window[0]
    for s, e in sorted(kernels) + [(window[1], window[1])]:
        if s > t:
            gaps.append((s - t, t, s))
        t = max(t, e)
    gaps.sort(reverse=True)
    out = []
    for length, s, e in gaps[:top]:
        mid = (s + e) / 2
        inner = [h for h in host if h[0] <= mid <= h[1]]
        name = min(inner, key=lambda h: h[1] - h[0])[2] if inner \
            else "host outside any traced operation"
        out.append([name, length / 1e6])
    return out


class Profiler:
    """``torch.profiler`` over the window: ``start()`` before it, ``close()``
    when it closes (from the metric logger, at the iteration that closes
    it), then ``result()``."""

    def __init__(self, calls: KernelCalls) -> None:
        self.calls = calls
        self.prof = None
        self.wall_s = 0.0

    def start(self) -> None:
        from torch.profiler import ProfilerActivity, profile
        import time

        torch.cuda.synchronize()
        self.prof = profile(activities=[ProfilerActivity.CPU,
                                        ProfilerActivity.CUDA])
        self.prof.start()
        # a tiny kernel first: a trace has missed the first kernel of its
        # window
        torch.ones(1, device="cuda").add_(1)
        torch.cuda.synchronize()
        self.calls.recording = True
        self._t0 = time.perf_counter()

    def close(self) -> None:
        import time

        if self.prof is None or not self.calls.recording:
            return
        self.calls.recording = False
        torch.cuda.synchronize()
        self.wall_s = time.perf_counter() - self._t0
        self.prof.stop()

    def result(self) -> "DeviceProfile":
        dev = torch.autograd.DeviceType.CUDA
        rows: Dict[str, Any] = {}
        kern, host, lo, hi = [], [], float("inf"), 0.0
        for e in self.prof.profiler.kineto_results.events():
            t, d = _span_us(e)
            lo, hi = min(lo, t), max(hi, t + d)
            if e.device_type() == dev:
                s, n = rows.get(e.name(), (0.0, 0))
                rows[e.name()] = (s + d / 1e6, n + 1)
                kern.append((t, t + d))
            else:
                host.append((t, t + d, e.name()))
        missed = _missed(rows, self.calls)
        busy = sum(s for s, _ in rows.values()) + sum(missed.values())
        ops = [[n, s] for n, (s, _) in rows.items()] + \
            [[f"{lab} (no profiler row; CUDA events)", s]
             for lab, s in missed.items()]
        ops.sort(key=lambda x: -x[1])
        prof = DeviceProfile(busy_s=busy, window_s=self.wall_s, rows=rows,
                             missed=missed, ops=ops[:10],
                             gaps=_idle_gaps(kern, host, (lo, hi)))
        for label in KERNELS:
            mine = self.calls.by_label(label)
            if mine:
                print(f"portbench: {label} {len(mine)} calls, "
                      f"{prof.seconds(label):.4f} s on the device "
                      f"(profiler rows and {missed.get(label, 0.0):.4f} s "
                      f"missed), {self.calls.seconds(label):.4f} s by CUDA "
                      f"events", file=sys.stderr)
        return prof

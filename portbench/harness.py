"""One run of one cell: set-up, the measured window, the judge, the result.

Set-up builds the configuration's operand on the device from the seed
(``operands/<kind>.py``) and hands it to the program as the driver takes
it, built once, as a rank search builds it; it builds the program's
kernels and warms every shape up with one short call of the cell's driver
(``entries/<entry>.py``). The window then calls the driver back to back,
the seed moving by one a call, until the first boundary past ``seconds``
that the cell's end-to-end metrics name (``end_to_end/<metric>.py``: the
end of a fit, or of an iteration). Only what ended inside the window
counts. Once it has closed, one of its fits, drawn from the seed, is
judged against the plain reference (``judge.py``).
"""

from __future__ import annotations

import dataclasses
import os
import random
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from typing import Any, Callable, Dict, List, Optional

import torch

from portbench import judge, reference, registry

# modules whose presence in the process refuses the run, by whole
# top-level name
FORBIDDEN = ("jax", "jaxlib", "flax", "singlet_tpu")


def forbidden_modules() -> List[str]:
    """Top-level names of loaded modules that the run may not load."""
    return sorted({name.split(".")[0] for name in list(sys.modules)}
                  & set(FORBIDDEN))


def process_age_s() -> float:
    """Seconds since this process started (Linux), to 10 ms."""
    with open("/proc/self/stat") as f:
        start_ticks = int(f.read().rsplit(")", 1)[1].split()[19])
    with open("/proc/uptime") as f:
        uptime = float(f.read().split()[0])
    return uptime - start_ticks / os.sysconf("SC_CLK_TCK")


def seed_base(seed: int) -> int:
    """The first fit's seed: 30 bits mixed from the run's seed
    (splitmix64), so that any whole number is a seed."""
    z = (int(seed) + 0x9E3779B97F4A7C15) & (2**64 - 1)
    z = ((z ^ (z >> 30)) * 0xBF58476D1CE4E5B9) & (2**64 - 1)
    z = ((z ^ (z >> 27)) * 0x94D049BB133111EB) & (2**64 - 1)
    return ((z ^ (z >> 31)) & 0x3FFFFFFF) + 1


def prebuild(sources) -> None:
    """Build the program's CUDA sources the cell runs, all at once (the
    first run in a checkout compiles them; later runs find them)."""
    if not sources:
        return
    from singlet_tpu_torch import _build

    with ThreadPoolExecutor(len(sources)) as pool:
        list(pool.map(_build.build, sources))


@dataclasses.dataclass
class Call:
    """One driver call of the window."""

    seed: int
    t_call: float
    t_return: float
    events: List[Dict[str, Any]]


@dataclasses.dataclass
class Run:
    """What the per-layer readers read: the window's calls (with the
    program's metric events), its start and end (``time.perf_counter``),
    and in a traced run the kernels' calls and the device profile."""

    cell: str
    config: Dict[str, Any]
    workload: Dict[str, Any]
    calls: List[Call]
    t0: float
    t_end: float
    kernels: Any = None
    profile: Any = None


def _sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def run_window(entry, drivers, P, args, seconds: float, first_seed: int,
               unit: str, events, steptap, keep_seed: int, device,
               close: Callable = lambda: None):
    """Call the driver back to back until the first boundary of ``unit``
    past ``seconds``; ``close()`` runs at that boundary. Returns (calls,
    start, end, count, the fit kept for the judge: (seed, answers,
    FitRecord, its iteration events))."""
    rng = random.Random(keep_seed)
    calls: List[Call] = []
    kept = None
    _sync(device)
    t0 = time.perf_counter()
    deadline = t0 + seconds
    if unit == "iteration":
        events.watch(deadline, close)
    while True:
        seed = first_seed + len(calls)
        n_ev = len(events.events)
        t_call = time.perf_counter()
        out = entry.call(drivers, P, seed, args)
        t_ret = time.perf_counter()
        evs = events.events[n_ev:]
        fits = steptap.take()
        if len(fits) != 1:
            raise RuntimeError(f"a call of the window ran {len(fits)} fits")
        calls.append(Call(seed, t_call, t_ret, evs))
        if rng.random() * len(calls) < 1.0:
            its = [e for e in evs if e["event"] == "iteration"]
            kept = (seed, entry.answers(out), fits[0], its)
        del out, fits
        if unit == "fit" and t_ret >= deadline:
            close()
            return calls, t0, t_ret, len(calls), kept
        if unit == "iteration":
            ends = [e["t"] for c in calls for e in c.events
                    if e["event"] == "iteration"]
            late = [t for t in ends if t >= deadline]
            if late:
                t_end = min(late)
                return calls, t0, t_end, sum(t <= t_end for t in ends), kept


def run_cell(root: str, cell: str, seed: int, seconds: float, trace: bool,
             device: str = "cuda",
             control: Optional[Dict[str, reference.Precision]] = None
             ) -> Dict[str, Any]:
    """One run of ``cell`` from the benchmark folder ``root``; the result
    line as a dict. ``control`` (a name and a precision each) adds, under
    "control", each control's readings of the judged fit: the reference
    at that precision in the program's place."""
    bench = registry.benchmark(root)
    wl = registry.workload(root, cell)
    cfg = registry.config(root, wl["config"])
    entry = registry.plugin(root, "entries", wl["entry"])
    kind = registry.plugin(root, "operands", cfg["operand"])
    e2e = {m["name"]: registry.plugin(root, "end_to_end", m["name"])
           for m in registry.cell_metrics(bench, cell, "end_to_end")
           if m["name"] != "setup_s"}
    layer = [m["name"] for m in registry.cell_metrics(bench, cell,
                                                      "per_layer")]
    units = {mod.BOUNDARY for mod in e2e.values()}
    if len(units) != 1:
        raise ValueError(f"{cell}: its end-to-end metrics {list(e2e)} close "
                         "the window at different boundaries")
    unit = units.pop()

    from singlet_tpu_torch import tracing
    from singlet_tpu_torch.device import set_precision_policy
    from singlet_tpu_torch.solvers import drivers
    from portbench import devtrace, tap

    set_precision_policy()
    cuda = torch.device(device).type == "cuda"
    if cuda:
        prebuild(cfg.get("sources", []))
    # a cell whose work the seed would change (fits that stop at a
    # data-dependent iteration, steps whose sweeps depend on the phase)
    # fixes its operand and its fits' seeds; the seed then draws which fit
    # and which columns are judged
    P, op = kind.build(cfg, int(wl.get("operand_seed", seed)), device)
    events = tap.Events()
    prev_logger = tracing.set_metric_logger(events)
    steptap = tap.StepTap(events)
    steptap.install()
    first = int(wl.get("first_fit_seed", seed_base(seed)))
    args = dict(wl["args"])
    try:
        # warm-up: the cell's driver once, at the window's shapes
        entry.call(drivers, P, first - 1, dict(args, **wl["warmup_args"]))
        _sync(device)
        steptap.take()
        events.events.clear()
        setup_s = process_age_s()
        # the device trace needs the card; on the CPU (tests) a traced run
        # gives the readers the window's calls and events alone
        on_card = trace and cuda
        kernels = devtrace.KernelCalls() if on_card else None
        profiler = devtrace.Profiler(kernels) if on_card else None
        if on_card:
            kernels.install()
            profiler.start()
        try:
            calls, t0, t_end, count, kept = run_window(
                entry, drivers, P, args, seconds, first, unit, events,
                steptap, seed ^ 0x5BD1E995, device,
                close=profiler.close if on_card else (lambda: None))
        finally:
            if on_card:
                profiler.close()
                kernels.finish()
        peak = torch.cuda.max_memory_allocated() if cuda else 0
    finally:
        steptap.remove()
        tracing.set_metric_logger(prev_logger)
    # the program's state goes before the judge runs; the reference reads
    # the operand, which is the benchmark's input, and the judged fit
    del P
    run = Run(cell, cfg, wl, calls, t0, t_end, kernels,
              profiler.result() if on_card else None)
    found = forbidden_modules()
    if found:
        raise ForbiddenModules(found)

    t_judge = time.perf_counter()
    fit_seed, answers, fit, its = kept
    rules = entry.rules(fit_seed, args)
    sample_seed = seed_base(seed) ^ fit_seed
    numbers, parts = judge.judge(fit, rules, its, answers, op, cfg,
                                 wl["check"], seed=sample_seed)
    n_iter = [e["n_iter"] for c in calls for e in c.events
              if e["event"] == "fit_end"]
    print(f"portbench: {cell} set-up {setup_s:.2f} s, window "
          f"{t_end - t0:.3f} s ({count} {unit}s counted, {len(calls)} "
          f"calls, iterations a fit {n_iter}), the last call ended "
          f"{calls[-1].t_return - t_end:.2f} s after the window, judge "
          f"{time.perf_counter() - t_judge:.2f} s (fit {fit_seed}, "
          f"{fit.steps} steps; parts {parts}; its test errors "
          f"{answers.get('test_error')})", file=sys.stderr)
    ms = sorted(e["ms"] for c in calls for e in c.events
                if e["event"] == "iteration" and e["t"] <= t_end)
    if ms:
        print(f"portbench: {len(ms)} iterations in the window, ms: min "
              f"{ms[0]:.1f}, median {ms[len(ms) // 2]:.1f}, max "
              f"{ms[-1]:.1f}, sum {sum(ms):.1f}", file=sys.stderr)
    limits = wl["limits"]
    checks = {name: dict(value=numbers[name], limit=limits[name])
              for name in numbers}
    correct = all(name in limits and v == v and v <= limits[name]
                  for name, v in numbers.items())
    if trace:
        metrics = {}
        for name in layer:
            mod = registry.metric_module(root, name)
            value = mod.read(run)
            if value is not None:
                metrics[name] = dict(value=value, unit=mod.UNIT)
    else:
        span = t_end - t0
        metrics = {name: dict(value=mod.value(span, count),
                              unit=_unit(bench, name))
                   for name, mod in e2e.items()}
        metrics["setup_s"] = dict(value=setup_s, unit="s")
    dev_info = dict(platform="gpu" if cuda else "cpu",
                    kind=torch.cuda.get_device_name() if cuda else "cpu",
                    count=1, memory_peak_bytes=int(peak))
    out = dict(correct=bool(correct), attempted=len(calls), failed=0,
               metrics=metrics, device=dev_info)
    if on_card:
        p = run.profile
        dev_info.update(busy_s=p.busy_s, window_s=p.window_s)
        out["breakdown"] = dict(device_ops=p.ops, idle_gaps=p.gaps)
    if control:
        out["parts"] = parts
        out["control"] = {}
        for name, prec in control.items():
            nums, cparts = judge.judge(fit, rules, its, answers, op, cfg,
                                       wl["check"], seed=sample_seed,
                                       control=prec)
            out["control"][name] = dict(nums, parts=cparts)
    out["checks"] = checks
    return out


class ForbiddenModules(RuntimeError):
    def __init__(self, found):
        super().__init__(f"modules the run may not load: {found}")
        self.found = found


def _unit(bench, name: str) -> str:
    return next(m["unit"] for m in bench["end_to_end"] if m["name"] == name)

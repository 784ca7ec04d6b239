"""Where the harness finds what belongs to one configuration, one cell or
one per-layer metric: files of their own, found by the name that
``BENCHMARK.json`` gives.

* ``configs/<config>.json``: the configuration (shapes, solver settings,
  source, ``reduced``, ``assumed``), and the kind of operand it is made
  as (``operand``);
* ``operands/<kind>.py``: ``build(cfg, seed, device)``, which makes the
  operand of that kind on the device from the seed and returns (what the
  program's driver takes, the reference's view of the same data);
* ``workloads/<cell>.json``: the cell's traffic: its configuration, the
  driver it calls (``entry``), the driver's
  arguments (``args``, and ``warmup_args`` over them for the warm-up
  call), the columns the judge samples (``check``), the limits of the
  numbers compared (``limits``), and, where the seed would change the
  work, the fixed seed of the operand (``operand_seed``) and of the
  window's first fit (``first_fit_seed``);
* ``entries/<entry>.py``: the driver a window calls: ``call(drivers, P,
  seed, args)``, ``rules(seed, args)`` (what the call's fit starts from
  and solves, a ``judge.FitRules``), ``answers(out)`` (what it returned to
  the user) and ``MASKED``;
* ``end_to_end/<metric>.py``: an end-to-end metric's ``BOUNDARY`` (the
  window closes at the first ``"fit"`` or ``"iteration"`` past its length)
  and ``value(span_s, count)`` (its value from the window's span and the
  count of what ended in it); ``setup_s`` is the harness's own;
* ``metrics/<metric>.py``: a per-layer metric's reader ``read(run)``, with
  ``LAYER`` and ``UNIT``; a metric ``a.b`` whose own file is absent is
  read by ``metrics/a.py`` (one reader for the quantity, the suffix naming
  the end-to-end metric it moves).

A new configuration, cell or per-layer metric is new files and new
entries of ``BENCHMARK.json``, with no file here edited.
"""

from __future__ import annotations

import importlib.util
import json
import os
from typing import Any, Dict, List, Optional

ROOT = os.path.dirname(os.path.abspath(__file__))


def load_json(path: str) -> Dict[str, Any]:
    with open(path) as f:
        return json.load(f)


def benchmark(root: str) -> Dict[str, Any]:
    """``BENCHMARK.json`` of the checkout whose ``portbench`` is ``root``."""
    return load_json(os.path.join(os.path.dirname(root), "BENCHMARK.json"))


def workload(root: str, cell: str) -> Dict[str, Any]:
    return load_json(os.path.join(root, "workloads", f"{cell}.json"))


def config(root: str, name: str) -> Dict[str, Any]:
    return load_json(os.path.join(root, "configs", f"{name}.json"))


_LOADED: Dict[str, Any] = {}


def plugin(root: str, folder: str, name: str, fallback: bool = False):
    """The module ``root/folder/<name>.py``, loaded once by its path; with
    ``fallback``, ``<a>.py`` for a name ``a.b`` whose own file is absent."""
    stems = (name, name.split(".")[0]) if fallback else (name,)
    for stem in stems:
        path = os.path.join(root, folder, f"{stem}.py")
        if os.path.isfile(path):
            if path not in _LOADED:
                spec = importlib.util.spec_from_file_location(
                    f"portbench_{folder}_{stem.replace('.', '_')}", path)
                mod = importlib.util.module_from_spec(spec)
                spec.loader.exec_module(mod)
                _LOADED[path] = mod
            return _LOADED[path]
    raise FileNotFoundError(f"no {name!r} under {os.path.join(root, folder)}")


def metric_module(root: str, name: str):
    """The reader module of per-layer metric ``name``."""
    return plugin(root, "metrics", name, fallback=True)


def cell_metrics(bench: Dict[str, Any], cell: str, kind: str) -> List[dict]:
    """The ``kind`` ("end_to_end" or "per_layer") metrics of ``bench``
    that ``cell`` reports: those that list it, and those that list no
    cells."""
    return [m for m in bench[kind]
            if cell in m.get("workloads", [cell])]


def cell_entry(bench: Dict[str, Any], cell: str) -> Optional[dict]:
    for w in bench["workloads"]:
        if w["name"] == cell:
            return w
    return None

"""Run one cell of the port's benchmark once and print its result line.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> \\
        --trace <0|1>

Run from the root of a checkout: the cell's files are found under
``portbench/`` by its name in ``BENCHMARK.json``, and the program
(``singlet_tpu_torch``) is imported from the checkout. The last line of
standard output is the result (JSON); each number compared for
``correct`` is printed with its limit as the last lines of standard error
and under "checks", the result's last key. Exits with another code than 0
and prints no result without a card, or with fewer cards than the cell
asks for, without the program beside the benchmark, or when the process
has loaded JAX or the JAX package.
"""

import argparse
import json
import os
import sys

BENCH_DIR = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(BENCH_DIR)


def _fail(msg: str, code: int = 2) -> None:
    print(f"portbench: {msg}", file=sys.stderr, flush=True)
    sys.exit(code)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    a = ap.parse_args(argv)

    # the configurations state the program's default routes: no knob of
    # the program may change them
    for key in [k for k in os.environ if k.startswith("SINGLET_TPU_")]:
        del os.environ[key]
    # build and kernel caches at fixed paths inside the checkout
    cache = os.path.join(ROOT, "build", "portbench")
    os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(cache, "torch_ext")
    os.environ["TRITON_CACHE_DIR"] = os.path.join(cache, "triton")
    if not os.path.isfile(os.path.join(ROOT, "singlet_tpu_torch",
                                       "__init__.py")):
        _fail(f"no singlet_tpu_torch beside {BENCH_DIR}")
    sys.path.insert(0, ROOT)

    from portbench import harness, registry

    bench = registry.benchmark(BENCH_DIR)
    entry = registry.cell_entry(bench, a.workload)
    if entry is None:
        _fail(f"no cell {a.workload!r} in BENCHMARK.json")
    import torch

    if not torch.cuda.is_available():
        _fail("torch.cuda.is_available() is False")
    if torch.cuda.device_count() < int(entry["chips"]):
        _fail(f"{a.workload} needs {entry['chips']} cards, "
              f"{torch.cuda.device_count()} found")
    try:
        out = harness.run_cell(BENCH_DIR, a.workload, a.seed, a.seconds,
                               bool(a.trace))
    except harness.ForbiddenModules as exc:
        _fail(f"the process loaded {', '.join(exc.found)}")
    found = harness.forbidden_modules()
    if found:
        _fail(f"the process loaded {', '.join(found)}")
    for name, c in out["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(out), flush=True)


if __name__ == "__main__":
    main()

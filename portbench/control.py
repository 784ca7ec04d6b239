"""The readings that the limits of ``correct`` are set from, on the card.

    python3 portbench/control.py --workload <cell> --seconds <s> \\
        --seeds <n> [<n> ...]

For each seed, one run of the cell (a window of ``--seconds``), in one
process: the numbers the program gives (its lower readings) and, for the
same judged fit, the numbers of each control, the plain reference put in
the program's place at the precision below the configuration's: TF32
products for the float32 ones and bfloat16 inputs to the tol's float32
sums, and where the mask products are int8, int4 mask products (alone,
then with the others). One JSON line a seed. The benchmark's own runs do
not run this.
"""

import argparse
import json
import os
import sys

BENCH_DIR = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(BENCH_DIR)


def controls(cfg):
    import torch

    from portbench.reference import Precision

    bf16 = torch.bfloat16
    out = {"tf32": Precision(dtype=torch.float32, tf32=True, q_max=127,
                             tol_inputs=bf16)}
    if cfg.get("mask_products") == "int8":
        out["int4"] = Precision(dtype=torch.float32, tf32=False, q_max=7)
        out["tf32_int4"] = Precision(dtype=torch.float32, tf32=True,
                                     q_max=7, tol_inputs=bf16)
    return out


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--controls", nargs="+",
                    help="the controls to read (default: all)")
    a = ap.parse_args(argv)
    for key in [k for k in os.environ if k.startswith("SINGLET_TPU_")]:
        del os.environ[key]
    sys.path.insert(0, ROOT)
    from portbench import harness, registry

    cfg = registry.config(BENCH_DIR,
                          registry.workload(BENCH_DIR, a.workload)["config"])
    ctl = {name: prec for name, prec in controls(cfg).items()
           if a.controls is None or name in a.controls}
    for seed in a.seeds:
        out = harness.run_cell(BENCH_DIR, a.workload, seed, a.seconds, False,
                               control=ctl)
        print(json.dumps(dict(
            seed=seed, correct=out["correct"],
            program={n: c["value"] for n, c in out["checks"].items()},
            parts=out["parts"],
            control=out["control"], metrics=out["metrics"])), flush=True)


if __name__ == "__main__":
    main()

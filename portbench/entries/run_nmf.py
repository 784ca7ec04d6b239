"""Entry ``run_nmf``: ``run_nmf(A, rank, ...)``, one plain fit at a fixed
rank a call, as a user calls it; the answer is the model (w, d, h sorted
by decreasing d). The fit starts from ``init_w(rank, seed=seed)``
(reference:R/run_nmf.R:56)."""

from portbench.judge import FitRules

MASKED = False


def call(drivers, P, seed: int, args):
    return drivers.run_nmf(P, seed=seed, **args)


def rules(seed: int, args) -> FitRules:
    k = int(args["rank"])
    return FitRules(masked=False, k=k, k_top=k, init_seed=seed,
                    tol=float(args.get("tol", 1e-4)),
                    L1=float(args.get("L1", 0.01)),
                    maxit=int(args.get("maxit", 100)))


def answers(out):
    return dict(w=out.w, d=out.d, h=out.h)

"""Entry ``cross_validate_nmf``: ``cross_validate_nmf(A, ranks,
n_replicates=1, ...)``, one masked fit a call (one rank, one replicate),
as a user calls it; the answer is the test-error trace. Replicate r
starts from ``init_w(max(ranks), seed=seed * 1000 + r)`` cut to k columns
and holds out the test set of mask seed ``seed + r``; the fit traces its
test error every ``trace_test_mse`` iterations and stops early when the
overfit score passes ``tol_overfit``
(reference:R/cross_validate_nmf.R:18-105)."""

from portbench.judge import FitRules

MASKED = True


def call(drivers, P, seed: int, args):
    return drivers.cross_validate_nmf(P, seed=seed, **args)


def rules(seed: int, args) -> FitRules:
    ranks = [int(r) for r in args["ranks"]]
    if len(ranks) != 1 or int(args.get("n_replicates", 3)) != 1:
        raise ValueError("a cross_validate_nmf cell runs one rank and one "
                         "replicate a call")
    return FitRules(masked=True, k=ranks[0], k_top=max(ranks),
                    init_seed=seed * 1000 + 1, mask_seed=seed + 1,
                    inv_density=round(1.0 / float(args.get("test_density",
                                                           0.05))),
                    tol=float(args.get("tol", 1e-4)),
                    L1=float(args.get("L1", 0.01)),
                    maxit=int(args.get("maxit", 100)),
                    trace_every=int(args.get("trace_test_mse", 5)),
                    overfit=float(args.get("tol_overfit", 1e-4)))


def answers(out):
    return dict(test_error=[float(e) for e in out["test_error"]])

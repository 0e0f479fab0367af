"""PCG steps a solve: the sum of ``SolveResult.diagnostics.pcg_iters`` over
the window's solves, over their number."""


def read(run):
    it = run.record.get("pcg_iters")
    return sum(sum(s) for s in it) / len(it) if it else None

"""Kernel launches a request: the kernels in the traced window (the span
markers' own aside) over the requests completed in it."""


def read(run):
    t, r = run.trace, run.record
    if t is None or not r["completed"]:
        return None
    n = t.launches() - r.get("marker_adds", 0)
    return n / r["completed"] if n > 0 else None

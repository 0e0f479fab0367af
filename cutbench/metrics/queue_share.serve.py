"""Share of request latency spent queued before a worker took the batch:
the server's per-request ``queue`` seconds over its ``total`` seconds,
summed over the window's requests, in %."""


def read(run):
    tm = run.record.get("timings") or []
    total = sum(t.get("total", 0.0) for t in tm)
    if total <= 0:
        return None
    return 100.0 * sum(t.get("queue", 0.0) for t in tm) / total

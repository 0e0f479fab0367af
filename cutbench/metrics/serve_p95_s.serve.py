"""The 95th percentile of request latency, submit to result on the
harness's clock, over every request of the window."""

import statistics


def read(run):
    lat = run.record.get("latencies") or []
    if len(lat) < 2:
        return None
    return statistics.quantiles(lat, n=20)[18]

"""Requests completed per second: every request completed in the window
over its wall, from the first burst's submit to the last burst's last
result (host clock)."""


def read(run):
    r = run.record
    return r["completed"] / r["wall_s"] if r["wall_s"] > 0 else None

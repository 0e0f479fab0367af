"""Seconds to a cut of one volume: the window's wall over the solves
completed in it (host clock)."""


def read(run):
    r = run.record
    return r["wall_s"] / r["completed"] if r["completed"] else None

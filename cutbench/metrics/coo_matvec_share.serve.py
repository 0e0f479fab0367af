"""Share of the window's device time spent in kernels launched inside
``core.laplacian.matvec_coo`` (the COO matvec), in %."""

SPAN = "repro_torch.core.laplacian:matvec_coo"


def read(run):
    t = run.trace
    secs = run.span(SPAN)
    if t is None or secs is None or t.device_s <= 0 or secs <= 0:
        return None
    return 100.0 * secs / t.device_s

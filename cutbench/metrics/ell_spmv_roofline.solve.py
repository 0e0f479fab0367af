"""``ell_spmv``'s share of its roofline: the bytes each call must move, from
the cell's shapes, over the kernel's device time, at 3.35 TB/s, in %."""

from cutbench import yardstick


def read(run):
    t = run.trace
    if t is None:
        return None
    calls, secs = t.kernel("ell_spmv")
    s = run.record["shape"]
    if not calls or secs <= 0 or "k" not in s:
        return None
    need = calls * yardstick.ell_spmv_bytes(s["n"], s["k"])
    return 100.0 * need / yardstick.HBM_BYTES_PER_S / secs

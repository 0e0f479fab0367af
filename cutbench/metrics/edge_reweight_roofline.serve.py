"""``edge_reweight``'s share of its roofline: the bytes each call must
move, from the cell's shapes and the batches' lanes (every batch of the
window padded to one bucket), over the kernel's device time, at 3.35
TB/s, in %."""

from cutbench import yardstick


def read(run):
    t = run.trace
    if t is None:
        return None
    calls, secs = t.kernel("edge_reweight")
    buckets = set((run.record.get("server") or {}).get("bucket_sizes") or [])
    if not calls or secs <= 0 or len(buckets) != 1:
        return None
    s = run.record["shape"]
    need = calls * yardstick.edge_reweight_bytes(s["n"], s["m"], buckets.pop())
    return 100.0 * need / yardstick.HBM_BYTES_PER_S / secs

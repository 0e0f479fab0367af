"""Mean lanes a batch: the server's batch sizes over the window
(``MinCutServer.stats``)."""


def read(run):
    s = run.record.get("server") or {}
    return s.get("mean_batch_size") or None

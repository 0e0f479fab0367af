"""The window's peak of device memory: ``torch.cuda.max_memory_allocated``
after a reset at the window's start, in GiB."""


def read(run):
    peak = run.record.get("peak_bytes")
    return None if peak is None else peak / 2 ** 30

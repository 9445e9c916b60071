"""``torch.cuda.max_memory_allocated`` over the window (reset at its
start, read at its end), in GiB."""


def read(run):
    return run.peak_bytes / 2 ** 30 if run.peak_bytes else None

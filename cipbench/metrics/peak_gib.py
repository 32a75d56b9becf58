"""GiB: ``torch.cuda.max_memory_allocated()`` over the program's set-up
and the window (the peak is reset once the benchmark's own data is on
the host)."""


def read(run):
    return None if run.peak_bytes is None else run.peak_bytes / 2**30

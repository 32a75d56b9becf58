"""Seconds per major cycle: the window over the cycles it completed."""
from cipbench.readers import per_call


def read(run):
    return per_call(run, "cycle", run.window_s)

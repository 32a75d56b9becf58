"""Seconds to a dirty image: the window over the images it completed."""
from cipbench.readers import per_call


def read(run):
    return per_call(run, "image", run.window_s)

"""Seconds: the 90th percentile of the window's images, each timed on
the host clock from its call to its image on the host."""
from cipbench.readers import p90


def read(run):
    return p90(run, "image")

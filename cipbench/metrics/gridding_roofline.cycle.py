"""Percent of the gridding kernels' roofline over the window: the algorithm's
least time (``work.py``) over their device time."""
from cipbench.readers import roofline


def read(run):
    return roofline(run, "cycle", "gridding")

"""Percent of the image psum's roofline: its least time
(``work_sharded.py``: the program's counter ``collective.all_reduce.bytes``
sent once and received once at NVLink's rate a direction) over the
seconds of its span ``collective.all_reduce``."""
from cipbench.work_sharded import psum_bytes, psum_least_seconds, psum_seconds


def read(run):
    if run.unit != "cycle":
        return None
    seconds, nbytes = psum_seconds(), psum_bytes()
    if not seconds or not nbytes:
        return None
    return 100.0 * psum_least_seconds(nbytes) / seconds

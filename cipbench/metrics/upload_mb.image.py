"""Megabytes an image uploads: the program's counter ``h2d_bytes``."""
from cipbench.readers import per_call
from cipbench.recorded import counter


def read(run):
    uploaded = counter("h2d_bytes")
    return per_call(run, "image", None if uploaded is None
                    else uploaded / 1e6)

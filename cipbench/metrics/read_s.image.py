"""Host seconds an image spends reading its dataset: the program's span ``read`` (``invert.py:invert_dataset``, the reader's load and the Stokes-I conversion)."""
from cipbench.readers import per_call
from cipbench.recorded import span_seconds


def read(run):
    return per_call(run, "image", span_seconds(["read"], "host_s"))

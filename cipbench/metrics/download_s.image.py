"""Host seconds an image waits for its download: the program's span ``download``."""
from cipbench.readers import per_call
from cipbench.recorded import span_seconds


def read(run):
    return per_call(run, "image", span_seconds(["download"], "host_s"))

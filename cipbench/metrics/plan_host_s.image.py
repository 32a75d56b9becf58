"""Host seconds an image spends planning: the program's span ``plan`` (``make_plan``)."""
from cipbench.readers import per_call
from cipbench.recorded import span_seconds


def read(run):
    return per_call(run, "image", span_seconds(["plan"], "host_s"))

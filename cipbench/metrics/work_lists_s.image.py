"""Host seconds an image spends building the invert's work lists: the program's span ``invert.work_lists``."""
from cipbench.readers import per_call
from cipbench.recorded import span_seconds


def read(run):
    return per_call(run, "image", span_seconds(["invert.work_lists"],
                                                "host_s"))

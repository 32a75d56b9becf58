"""Host seconds a cycle spends issuing the residual gradient: the program's span ``gradient``."""
from cipbench.readers import per_call
from cipbench.recorded import span_seconds


def read(run):
    return per_call(run, "cycle", span_seconds(["gradient"], "host_s"))

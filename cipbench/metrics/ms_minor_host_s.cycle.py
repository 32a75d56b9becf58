"""Host seconds a cycle spends issuing the multiscale minor loop: the program's span ``multiscale.minor``."""
from cipbench.readers import per_call
from cipbench.recorded import span_seconds


def read(run):
    return per_call(run, "cycle", span_seconds(["multiscale.minor"],
                                               "host_s"))

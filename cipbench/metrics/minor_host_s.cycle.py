"""Host seconds a cycle spends issuing the minor cycle: the program's span ``minor``."""
from cipbench.readers import per_call
from cipbench.recorded import span_seconds


def read(run):
    return per_call(run, "cycle", span_seconds(["minor"], "host_s"))

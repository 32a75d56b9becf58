"""Host seconds an image spends staging: the program's span ``stage`` (host arrays, uploads, the prologue's issue)."""
from cipbench.readers import per_call
from cipbench.recorded import span_seconds


def read(run):
    return per_call(run, "image", span_seconds(["stage"], "host_s"))

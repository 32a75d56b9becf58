"""Device seconds a cycle spends making the scale frames: the program's device span ``multiscale.frames`` (the S scale convolutions of the residual)."""
from cipbench.readers import per_call
from cipbench.recorded import span_seconds


def read(run):
    return per_call(run, "cycle", span_seconds(["multiscale.frames"],
                                               "device_s"))

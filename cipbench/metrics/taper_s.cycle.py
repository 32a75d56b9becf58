"""Device seconds a cycle spends on the taper maps: the program's device spans ``predict.taper`` and ``invert.taper``."""
from cipbench.readers import per_call
from cipbench.recorded import span_seconds


def read(run):
    return per_call(run, "cycle", span_seconds(
        ["predict.taper", "invert.taper"], "device_s"))

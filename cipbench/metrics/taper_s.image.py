"""Device seconds an image spends on the taper maps: the program's device span ``invert.taper``."""
from cipbench.readers import per_call
from cipbench.recorded import span_seconds


def read(run):
    return per_call(run, "image", span_seconds(["invert.taper"], "device_s"))

"""Percent of the scale convolutions' roofline over the window: their
least time (``work_multiscale.py``: the residual read and the frames
written once, or the FFT route's flops) over the device seconds of the
program's span ``multiscale.frames``; nothing without a device trace."""
from cipbench.readers import per_call
from cipbench.recorded import span_seconds


def read(run):
    if run.trace is None or "scale_conv" not in run.bounds:
        return None
    seconds = per_call(run, "cycle", span_seconds(["multiscale.frames"],
                                                  "device_s"))
    if not seconds:
        return None
    return 100.0 * run.bounds["scale_conv"] / len(run.calls) / seconds

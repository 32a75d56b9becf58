"""Seconds an image spends staging: host arrays, upload, the device prologue."""
from cipbench.readers import span_per_call

SPANS = {"stage": "ska_sdp_cip_tpu_torch.ops.gridder:stage_compact"}


def read(run):
    return span_per_call(run, "image", "stage")

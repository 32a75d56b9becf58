"""Seconds a cycle spends in the residual gradient: predict, slot residual, invert."""
from cipbench.readers import span_per_call

SPANS = {"gradient": "ska_sdp_cip_tpu_torch.models.operators:MeasurementOperator.residual_gradient"}


def read(run):
    return span_per_call(run, "cycle", "gradient")

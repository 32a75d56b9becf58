"""Seconds a cycle spends in the minor cycle."""
from cipbench.readers import span_per_call

SPANS = {"minor": "ska_sdp_cip_tpu_torch.models.clean:hogbom_clean"}


def read(run):
    return span_per_call(run, "cycle", "minor")

"""Host seconds an image spends in the planner (the C++ engine)."""
from cipbench.readers import span_per_call

SPANS = {"plan": "ska_sdp_cip_tpu_torch.ops.gridder:make_plan"}


def read(run):
    return span_per_call(run, "image", "plan")

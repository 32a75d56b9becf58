"""Gridding operators (counterpart: ska_sdp_cip_tpu/ops/__init__.py)."""

from .gridder import dirty_image
from .plan import GridderPlan, make_plan, plan_from_fields

__all__ = ["GridderPlan", "make_plan", "plan_from_fields", "dirty_image"]

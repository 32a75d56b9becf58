"""
Solvers on the measurement operator (counterpart:
ska_sdp_cip_tpu/models/__init__.py). ``multiscale_clean``,
``fista_clean`` and the weighting schemes are still to be ported
(ROADMAP.md, queue A).
"""

from .checkpoint import MajorCycleCheckpoint, graceful_shutdown
from .clean import build_major_cycle_step, hogbom_clean, major_cycle_clean
from .operators import MeasurementOperator, SlotVis, as_split_pair
from .restore import restore_image

__all__ = [
    "MeasurementOperator",
    "SlotVis",
    "as_split_pair",
    "restore_image",
    "hogbom_clean",
    "major_cycle_clean",
    "build_major_cycle_step",
    "MajorCycleCheckpoint",
    "graceful_shutdown",
]

"""
Solvers on the measurement operator (counterpart:
ska_sdp_cip_tpu/models/__init__.py): Hogbom/Clark, multiscale and FISTA
deconvolution, restoration, checkpoints, and the imaging weighting
schemes (natural, uniform, Briggs robust).
"""

from .checkpoint import MajorCycleCheckpoint, graceful_shutdown
from .clean import build_major_cycle_step, hogbom_clean, major_cycle_clean
from .fista import fista_clean
from .multiscale import multiscale_clean
from .operators import MeasurementOperator, SlotVis, as_split_pair
from .restore import restore_image
from .weighting import ImagingWeighter, fit_weighter_for_reader

__all__ = [
    "MeasurementOperator",
    "SlotVis",
    "as_split_pair",
    "fista_clean",
    "multiscale_clean",
    "restore_image",
    "hogbom_clean",
    "major_cycle_clean",
    "build_major_cycle_step",
    "MajorCycleCheckpoint",
    "graceful_shutdown",
    "ImagingWeighter",
    "fit_weighter_for_reader",
]

"""
ska_sdp_cip_tpu_torch — the PyTorch/CUDA port of ``ska_sdp_cip_tpu``.

Counterpart: ``ska_sdp_cip_tpu/__init__.py``. The JAX package stays the
reference; this package mirrors its layout module for module and runs
the same invert path (visibility dataset -> dirty image) on an NVIDIA
Hopper card through hand-written CUDA kernels (``csrc/``), or on the
CPU through their plain PyTorch versions, and its adjoint, predict
(image -> visibilities), which closes the Hogbom/Clark, multiscale and
FISTA major cycles (``models``), over one device or a mesh of shards
on ``torch.distributed`` (``parallel``), behind the imaging CLI
``tpu-cip-torch`` (``apps/pipeline_app.py``). It imports ``torch`` and
numpy only — never ``jax`` and never the JAX package — because the
machine that carries the card has no JAX at all. Framework-free host
code (planner, VZ reader, synthetic data, DFT oracle) is therefore
carried here as copies, held equal to the originals by the tests.

Every public entry point takes an explicit ``device``; nothing picks a
device on the caller's behalf.
"""

from ._version import __version__
from .invert import invert_dataset, sharded_invert_dataset
from .io.visibility_dataset import VisibilityReader
from .ops.gridder import predict_visibilities
from .wgridder import dirty2ms

# Alias matching the reference's public name (MeasurementSetReader).
MeasurementSetReader = VisibilityReader

__all__ = [
    "__version__",
    "VisibilityReader",
    "MeasurementSetReader",
    "invert_dataset",
    "sharded_invert_dataset",
    "predict_visibilities",
    "dirty2ms",
]

"""
The multi-device path on ``torch.distributed`` (counterpart:
``ska_sdp_cip_tpu/parallel``): the process group and shard mesh
(``mesh.py``), the sharded invert (``sharded_invert.py``), the sharded
major cycles (``sharded_clean.py``) and the ``torchrun`` launcher
(``launch.py``).
"""

from .mesh import DeviceMesh, initialize_distributed, make_device_mesh
from .sharded_invert import sharded_invert_dataset

__all__ = [
    "DeviceMesh",
    "make_device_mesh",
    "initialize_distributed",
    "sharded_invert_dataset",
]

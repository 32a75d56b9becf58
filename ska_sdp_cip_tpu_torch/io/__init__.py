"""Visibility I/O (counterpart: ska_sdp_cip_tpu/io/__init__.py)."""

from .visibility_dataset import (
    UnsupportedLayout,
    VisibilityDatasetMetadata,
    VisibilityReader,
)

__all__ = [
    "UnsupportedLayout",
    "VisibilityDatasetMetadata",
    "VisibilityReader",
]

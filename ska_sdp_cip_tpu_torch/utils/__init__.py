"""Host utilities (counterpart: ska_sdp_cip_tpu/utils/__init__.py)."""

from .chunking import balanced_chunk_bounds, balanced_chunk_sizes

__all__ = ["balanced_chunk_sizes", "balanced_chunk_bounds"]

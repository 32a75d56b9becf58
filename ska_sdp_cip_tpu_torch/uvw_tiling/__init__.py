"""
UVW tiling: spatial partitioning of the visibility scatter domain
(reference package: src/ska_sdp_cip/uvw_tiling/__init__.py:1-17).
"""

from .reorder import reorder_by_uvw_tile
from .tile import Tile, concatenate_tiles, rechunk_tiles_on_disk, split_tile
from .tiling_plan import (
    RowSliceId,
    TileCoords,
    TileMapping,
    compute_tile_indices,
    create_uvw_tile_mapping,
    merge_tile_mappings,
)

__all__ = [
    "compute_tile_indices",
    "create_uvw_tile_mapping",
    "merge_tile_mappings",
    "reorder_by_uvw_tile",
    "RowSliceId",
    "TileCoords",
    "TileMapping",
    "Tile",
    "concatenate_tiles",
    "split_tile",
    "rechunk_tiles_on_disk",
]

"""
UVW tile binning plan.

Assigns every (row, channel) visibility sample to a 3-D UVW tile —
the spatial partitioning that makes gridding scatter-local
(reference: src/ska_sdp_cip/uvw_tiling/tiling_plan.py). Tile (0, 0, 0)
is centred on the origin:

    tile_index = floor((uvw / c) * freq / tile_size + 0.5)

The reference finds constant-tile channel runs per row with a recursive
binary search parallelized over a multiprocessing pool
(tiling_plan.py:84-181); here the whole computation is one vectorized
numpy pass (run-length segmentation over the channel axis), which is
both the host-side implementation and the template for the on-device
jnp version used at ingest.
"""

from __future__ import annotations

from collections import defaultdict
from typing import NamedTuple

import numpy as np
from numpy.typing import NDArray

SPEED_OF_LIGHT = 299792458.0

TileCoords = tuple
"""Tile index of the form (iu, iv, iw)."""


class RowSliceId(NamedTuple):
    """A slice of one visibility row along the frequency axis."""

    irow: int
    chan_start: int
    chan_stop: int


TileMapping = dict
"""dict[TileCoords, list[RowSliceId]]"""


def compute_tile_indices(
    uvw: NDArray,
    tile_size: tuple,
    channel_freqs: NDArray,
) -> NDArray:
    """
    Integer tile indices for every (row, channel) sample, shape
    ``(nrows, nchan, 3)`` (reference formula: tiling_plan.py:46-51).
    """
    scale = np.asarray(channel_freqs, dtype=np.float64) / SPEED_OF_LIGHT
    inv_tile = 1.0 / np.asarray(tile_size, dtype=np.float64)
    # (nrows, nchan, 3)
    coords = (
        uvw[:, None, :] * scale[None, :, None] * inv_tile[None, None, :]
    )
    return np.floor(coords + 0.5).astype(np.int64)


def create_uvw_tile_mapping(
    uvw: NDArray,
    tile_size: tuple,
    channel_freqs: NDArray,
    *,
    row_offset: int = 0,
    processes: int | None = None,  # accepted for API compat; unused
) -> TileMapping:
    """
    Bin visibilities by UVW tile, returning
    ``{tile_coords: [RowSliceId, ...]}`` with maximal constant-tile
    channel runs per row (channel frequencies must be monotonic, as in
    the reference: tiling_plan.py:150-181).

    Vectorized run-length segmentation: a single numpy pass replaces
    the reference's per-row recursive binary search and its
    multiprocessing pool (tiling_plan.py:84-134).
    """
    uvw = np.asarray(uvw, dtype=np.float64)
    num_rows = len(uvw)
    num_chans = len(channel_freqs)
    if num_rows == 0:
        return {}

    tiles = compute_tile_indices(uvw, tile_size, channel_freqs)

    # Channel positions where the tile index changes within a row
    changed = np.zeros((num_rows, num_chans), dtype=bool)
    changed[:, 0] = True
    if num_chans > 1:
        changed[:, 1:] = np.any(np.diff(tiles, axis=1) != 0, axis=-1)

    row_idx, start_chan = np.nonzero(changed)
    #

    # Run stops: next run start within the row, else num_chans
    stop_chan = np.empty_like(start_chan)
    stop_chan[:-1] = start_chan[1:]
    stop_chan[-1] = num_chans
    row_boundary = np.empty_like(row_idx, dtype=bool)
    row_boundary[:-1] = row_idx[:-1] != row_idx[1:]
    row_boundary[-1] = True
    stop_chan = np.where(row_boundary, num_chans, stop_chan)

    run_tiles = tiles[row_idx, start_chan]

    mapping: TileMapping = defaultdict(list)
    row_idx = row_idx + row_offset
    for irow, c0, c1, (iu, iv, iw) in zip(
        row_idx.tolist(),
        start_chan.tolist(),
        stop_chan.tolist(),
        run_tiles.tolist(),
    ):
        mapping[(iu, iv, iw)].append(RowSliceId(irow, c0, c1))
    return dict(mapping)


# The vectorized implementation IS the sequential one; alias kept for
# reference API parity (tiling_plan.py:29-61).
create_uvw_tile_mapping_sequential = create_uvw_tile_mapping


def merge_tile_mappings(tile_mappings: list) -> TileMapping:
    """Merge tile mappings into one (reference: tiling_plan.py:137-147)."""
    result = defaultdict(list)
    for mapping in tile_mappings:
        for tile_coords, row_slices in mapping.items():
            result[tile_coords].extend(row_slices)
    return dict(result)
